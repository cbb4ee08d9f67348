"""CLIP embedding production: articles → 512-d image and text vectors — the
port of the JAX package's ``data/clip_embed.py`` (the reference produces
them in Colab notebooks, SURVEY §2a, for ``run_preprocessing_fashion.py:
129-162`` to read).

Both CLIP towers are the port's own ``nn.Module``\\ s (:class:`ClipModel`),
so the card needs no ``transformers``:

* text: token and position embeddings, pre-LN blocks (``quick_gelu`` MLP),
  attention under a causal mask combined with a mask up to the first eos,
  ``final_layer_norm``, the hidden state pooled at the first
  ``eos_token_id`` (at ``argmax(ids)`` when the config says 2, as
  ``modeling_flax_clip.py`` does for the released checkpoints), then
  ``text_projection`` without bias;
* vision: a patch conv without bias, the class embedding, position
  embeddings, ``pre_layrnorm``, the blocks, ``post_layernorm`` on the class
  token and ``visual_projection``.

The parameter names are those of ``transformers``' PyTorch ``CLIPModel``;
:func:`clip_params_from_flax` carries a Flax parameter tree across. The
weights stay f32; with ``compute_dtype`` bf16 (the default, as in the JAX
package) the matmuls, the convolution and attention run in bf16 while the
residual stream and the LayerNorm statistics stay f32. Inputs go through in
one fixed batch shape, the tail padded with copies of its last row. Outputs
are L2-normalised f32, written as the npz artifact ``preprocess_fashion``
loads: ``{str(raw_article_id): float32[proj_dim]}``.

No Pallas kernel is behind CLIP in the JAX package; plain PyTorch ops
(``F.scaled_dot_product_attention`` among them) are the port's version.
Pretrained ViT-B/32 weights come only from a local HuggingFace checkout
(``weights=``, loaded through ``transformers`` with ``local_files_only``);
nothing is fetched. Without weights the model is initialised at random from
``seed`` and text goes through the deterministic hashing tokenizer.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device

# CLIP's BPE vocab pins these two ids; the hashing fallback reuses them so
# randomly initialised runs see well-formed (bos, tokens…, eos, pad) rows.
_BOS, _EOS = 49406, 49407
_MAX_LEN = 77
# ViT-B/32 pixel normalisation (OpenAI CLIP preprocessing constants).
_PIXEL_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
_PIXEL_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def hash_tokenize(
    texts: Sequence[str],
    vocab_size: int,
    max_len: int = _MAX_LEN,
    bos: Optional[int] = None,
    eos: Optional[int] = None,
) -> np.ndarray:
    """Deterministic offline tokenizer fallback: lowercased whitespace words
    hashed (FNV-1a) into the vocab range, framed with CLIP's bos/eos ids.
    Not a BPE replacement — only for randomly initialised runs, where token
    identity is arbitrary anyway. ``eos`` must match the model config's
    ``eos_token_id``: the text tower pools at the first position holding it."""
    bos = min(_BOS, vocab_size - 2) if bos is None else bos
    eos = min(_EOS, vocab_size - 1) if eos is None else eos
    out = np.full((len(texts), max_len), eos, np.int32)  # CLIP pads with eos
    for r, t in enumerate(texts):
        ids = [bos]
        for w in t.lower().split()[: max_len - 2]:
            h = 2166136261
            for b in w.encode("utf-8"):
                h = ((h ^ b) * 16777619) & 0xFFFFFFFF
            ids.append(h % max(1, vocab_size - 2))
        ids.append(eos)
        out[r, : len(ids)] = np.asarray(ids, np.int32)
    return out


# ---- configuration: the defaults of transformers' CLIPConfig() (ViT-B/32) ----

@dataclass
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    bos_token_id: int = 49406
    eos_token_id: int = 49407


@dataclass
class ClipVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclass
class ClipConfig:
    text_config: ClipTextConfig = field(default_factory=ClipTextConfig)
    vision_config: ClipVisionConfig = field(default_factory=ClipVisionConfig)
    projection_dim: int = 512

    @classmethod
    def from_any(cls, cfg) -> "ClipConfig":
        """The port's config from its own, a ``transformers.CLIPConfig`` (read
        by attribute) or a dict of the same fields."""
        if cfg is None:
            return cls()
        if isinstance(cfg, cls):
            return cfg

        def get(obj, name):
            return obj[name] if isinstance(obj, dict) else getattr(obj, name)

        def sub(kind, obj):
            return kind(**{f.name: get(obj, f.name) for f in dataclasses.fields(kind)})

        return cls(text_config=sub(ClipTextConfig, get(cfg, "text_config")),
                   vision_config=sub(ClipVisionConfig, get(cfg, "vision_config")),
                   projection_dim=int(get(cfg, "projection_dim")))


# ---- the towers ---------------------------------------------------------------

def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(f"unsupported hidden_act {name!r}")


def _linear(x: torch.Tensor, lin: nn.Linear, dt: torch.dtype) -> torch.Tensor:
    b = None if lin.bias is None else lin.bias.to(dt)
    return F.linear(x.to(dt), lin.weight.to(dt), b)


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dt: torch.dtype) -> torch.Tensor:
    """Statistics in f32 (as Flax's LayerNorm computes them), output in ``dt``."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(dt)


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (nn.Linear(d, d) for _ in range(4))

    def forward(self, x, mask, dt):
        b, n, d = x.shape
        q, k, v = (_linear(x, p, dt).view(b, n, self.heads, d // self.heads).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return _linear(o.transpose(1, 2).reshape(b, n, d), self.out_proj, dt)


class _Mlp(nn.Module):
    def __init__(self, d: int, hidden: int, act: str):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, hidden), nn.Linear(hidden, d)
        self.act = _act(act)

    def forward(self, x, dt):
        return _linear(self.act(_linear(x, self.fc1, dt)), self.fc2, dt)


class _Layer(nn.Module):
    """A pre-LN block; the residual stream stays f32."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = _Attention(d, cfg.num_attention_heads)
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(d, cfg.intermediate_size, cfg.hidden_act)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, x, mask, dt):
        x = x + self.self_attn(_layer_norm(x, self.layer_norm1, dt), mask, dt).float()
        return x + self.mlp(_layer_norm(x, self.layer_norm2, dt), dt).float()


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask, dt):
        for layer in self.layers:
            x = layer(x, mask, dt)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class ClipTextTower(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Pooled hidden states [B, hidden] (f32) of int ids [B, L]."""
        n = ids.shape[1]
        x = (self.embeddings.token_embedding(ids)
             + self.embeddings.position_embedding.weight[:n][None])
        eos_id = self.cfg.eos_token_id
        # the first eos (argmax over the ids for the released configs' eos 2,
        # whose tokenizer emits the largest id 49407 as eos)
        eos = ids.argmax(1) if eos_id == 2 else (ids == eos_id).int().argmax(1)
        pos = torch.arange(n, device=ids.device)
        # a query sees the keys before it (causal) and none past the first eos
        mask = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] <= eos[:, None, None])
        x = self.encoder(x, mask[:, None], dt)
        x = F.layer_norm(x, self.final_layer_norm.normalized_shape, self.final_layer_norm.weight,
                         self.final_layer_norm.bias, self.final_layer_norm.eps)
        return x[torch.arange(ids.shape[0], device=ids.device), eos]


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding((cfg.image_size // cfg.patch_size) ** 2 + 1, d)


class ClipVisionTower(nn.Module):
    def __init__(self, cfg: ClipVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, pixels: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """Pooled class-token states [B, hidden] (f32) of pixels [B, 3, S, S]."""
        e = self.embeddings
        patches = F.conv2d(pixels.to(dt), e.patch_embedding.weight.to(dt),
                           stride=e.patch_embedding.stride)
        x = patches.flatten(2).transpose(1, 2).float()
        cls = e.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + e.position_embedding.weight[None]
        x = self.encoder(_layer_norm(x, self.pre_layrnorm, torch.float32), None, dt)
        pooled = x[:, 0]
        return F.layer_norm(pooled, self.post_layernorm.normalized_shape,
                            self.post_layernorm.weight, self.post_layernorm.bias,
                            self.post_layernorm.eps)


class ClipModel(nn.Module):
    """Both CLIP towers and their projections (``transformers``' ``CLIPModel``
    parameter names)."""

    def __init__(self, cfg: Optional[ClipConfig] = None):
        super().__init__()
        self.config = cfg = ClipConfig.from_any(cfg)
        self.text_model = ClipTextTower(cfg.text_config)
        self.vision_model = ClipVisionTower(cfg.vision_config)
        self.text_projection = nn.Linear(cfg.text_config.hidden_size, cfg.projection_dim,
                                         bias=False)
        self.visual_projection = nn.Linear(cfg.vision_config.hidden_size, cfg.projection_dim,
                                           bias=False)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def init_random_(self, generator: torch.Generator) -> "ClipModel":
        """Weights drawn from ``generator``: N(0, 0.02) for every matrix,
        embedding and the class token, LayerNorms at identity, biases 0."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name == "logit_scale":
                    continue
                if "norm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, 0.02, generator=generator)
        return self

    def text_features(self, ids: torch.Tensor, dt=torch.float32) -> torch.Tensor:
        return _linear(self.text_model(ids, dt), self.text_projection, dt).float()

    def image_features(self, pixels: torch.Tensor, dt=torch.float32) -> torch.Tensor:
        return _linear(self.vision_model(pixels, dt), self.visual_projection, dt).float()


def clip_params_from_flax(params) -> dict:
    """A Flax ``CLIPModel`` parameter tree (nested dicts of arrays) as a
    :class:`ClipModel` state dict: Dense kernels [in, out] → [out, in], the
    patch conv HWIO → OIHW, LayerNorm ``scale`` → ``weight``, ``embedding``
    → ``weight``."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, path + [k])
                continue
            a = np.array(v, np.float32)
            name = k
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            elif k in ("scale", "embedding"):
                name = "weight"
            out[".".join(path + [name])] = torch.from_numpy(np.ascontiguousarray(a).copy())

    walk(params, [])
    return out


def _hf_state_dict(weights: str):
    """(config, state dict) of a local HuggingFace CLIP checkout, read by
    ``transformers``' PyTorch ``CLIPModel`` without touching the network."""
    from transformers import CLIPModel

    hf = CLIPModel.from_pretrained(weights, local_files_only=True)
    sd = {k: v.float() for k, v in hf.state_dict().items() if not k.endswith("position_ids")}
    return hf.config, sd


class ClipEmbedder:
    """Batched CLIP feature extractor for both towers, on ``device``.

    Parameters
    ----------
    weights: optional local HF checkout dir (its config, weights and
        tokenizer). ``None`` → random weights from ``seed``.
    config: a :class:`ClipConfig`, a ``transformers.CLIPConfig`` or None
        (ViT-B/32). Ignored when ``weights`` is given.
    batch_size: one device batch shape; a final partial batch is padded.
    compute_dtype: the matmuls' dtype (bf16 by default; weights stay f32).
    state_dict: weights to load in place of random ones (e.g. from
        :func:`clip_params_from_flax`).
    """

    def __init__(
        self,
        weights: Optional[str] = None,
        config=None,
        batch_size: int = 256,
        compute_dtype=torch.bfloat16,
        tokenizer: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
        device="cuda",
        seed: int = 0,
        state_dict: Optional[dict] = None,
    ):
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.compute_dtype = compute_dtype
        if weights is not None:
            config, state_dict = _hf_state_dict(weights)
            if tokenizer is None:
                from transformers import CLIPTokenizerFast

                tok = CLIPTokenizerFast.from_pretrained(weights, local_files_only=True)

                def tokenizer(texts):
                    enc = tok(list(texts), padding="max_length", truncation=True,
                              max_length=_MAX_LEN, return_tensors="np")
                    return enc["input_ids"].astype(np.int32)

        with torch.device(self.device):
            self.model = ClipModel(config).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        else:
            self.model.init_random_(torch.Generator(device=self.device).manual_seed(seed))
        self.config = self.model.config
        self.image_size = int(self.config.vision_config.image_size)
        self.proj_dim = int(self.config.projection_dim)
        tc = self.config.text_config
        self._tokenize = tokenizer or (lambda texts: hash_tokenize(
            texts, int(tc.vocab_size), bos=int(tc.bos_token_id), eos=int(tc.eos_token_id)))
        self._mean = torch.from_numpy(_PIXEL_MEAN).to(self.device)
        self._std = torch.from_numpy(_PIXEL_STD).to(self.device)

    # ------------------------------------------------------------------ text
    def _text_batch(self, ids: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.ascontiguousarray(ids).astype(np.int64)).to(self.device)
        return F.normalize(self.model.text_features(ids, self.compute_dtype), dim=-1)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """``[N, proj_dim]`` float32, unit-norm."""
        return self._run_batched(self._text_batch, self._tokenize(list(texts)))

    # ----------------------------------------------------------------- image
    def preprocess_images(self, images: np.ndarray) -> np.ndarray:
        """uint8/float ``[N, H, W, 3]`` → CLIP-normalised ``[N, 3, S, S]`` on
        the host. H and W must already equal the model's image_size."""
        x = np.asarray(images)
        if x.dtype == np.uint8:
            x = x.astype(np.float32) / 255.0
        s = self.image_size
        assert x.shape[1:] == (s, s, 3), (x.shape, s)
        x = (x - _PIXEL_MEAN) / _PIXEL_STD
        return np.transpose(x, (0, 3, 1, 2)).astype(np.float32)

    def _image_batch(self, images: np.ndarray) -> torch.Tensor:
        """One batch of ``[B, S, S, 3]`` images, moved as they are (uint8
        moves a quarter of f32's bytes) and normalised on the device with
        :meth:`preprocess_images`' arithmetic."""
        s = self.image_size
        assert images.shape[1:] == (s, s, 3), (images.shape, s)
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
        x = ((x - self._mean) / self._std).permute(0, 3, 1, 2)
        return F.normalize(self.model.image_features(x, self.compute_dtype), dim=-1)

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        """``[N, H, W, 3]`` (uint8 or [0,1] float) → ``[N, proj_dim]``."""
        return self._run_batched(self._image_batch, np.asarray(images))

    def _run_batched(self, fn, arr: np.ndarray) -> np.ndarray:
        n, b = len(arr), self.batch_size
        outs = []
        with torch.no_grad():
            for lo in range(0, n, b):
                chunk = arr[lo: lo + b]
                if len(chunk) < b:  # pad: every batch has one shape
                    chunk = np.concatenate([chunk, np.repeat(chunk[-1:], b - len(chunk), 0)])
                outs.append(fn(chunk)[: min(b, n - lo)])
        if not outs:
            return np.zeros((0, self.proj_dim), np.float32)
        return torch.cat(outs).cpu().numpy()


def write_embeddings_npz(path: str, raw_article_ids: Sequence, vectors: np.ndarray) -> None:
    """Write the artifact ``preprocess_fashion`` consumes:
    ``{str(raw_id): float32[proj_dim]}`` (the reference notebooks' output,
    loaded at ``preprocess_fashion.py:141-158``)."""
    assert len(raw_article_ids) == len(vectors)
    np.savez(path, **{str(r): vectors[i].astype(np.float32)
                      for i, r in enumerate(raw_article_ids)})


def produce_article_embeddings(
    raw_dir: str,
    raw_article_ids: Sequence,
    texts: Optional[List[str]] = None,
    images: Optional[np.ndarray] = None,
    embedder: Optional[ClipEmbedder] = None,
    **embedder_kw,
) -> ClipEmbedder:
    """End-to-end producer: embeds whatever modalities are given and writes
    ``text_embeddings.npz`` / ``image_embeddings.npz`` into ``raw_dir`` for
    ``preprocess_fashion`` (``config.load_{image,text}_embedding``)."""
    emb = embedder or ClipEmbedder(**embedder_kw)
    if texts is not None:
        write_embeddings_npz(os.path.join(raw_dir, "text_embeddings.npz"),
                             raw_article_ids, emb.embed_texts(texts))
    if images is not None:
        write_embeddings_npz(os.path.join(raw_dir, "image_embeddings.npz"),
                             raw_article_ids, emb.embed_images(images))
    return emb
