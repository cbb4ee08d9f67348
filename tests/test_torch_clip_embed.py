"""CLIP embedding production in the PyTorch port against the JAX package's
``data/clip_embed.py`` (``transformers.FlaxCLIPModel``): the tiny config of
``tests/test_clip_embed.py``, the Flax parameters carried across with
``clip_params_from_flax``, text and image features within 1e-5 in f32 (one
model's f32 sums in another order); ``hash_tokenize`` equal; the npz
artifact with the same keys and vectors (and byte for byte from the same
vectors); the bf16 default against f32 (cosine ≥ 0.99, the bound the card
run holds); a local HuggingFace checkout through ``weights=`` against
``transformers``' PyTorch ``CLIPModel`` (1e-5); the port's own ViT-B/32
defaults against ``CLIPConfig()``; and the artifact feeding the port's
``preprocess_fashion``. Tests that need ``transformers`` (every one that
builds the JAX model) or pandas skip where it is missing."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from laplace_gnn_recommendation_tpu_torch.constants import NODE_ITEM
from laplace_gnn_recommendation_tpu_torch.data import clip_embed as T
from laplace_gnn_recommendation_tpu_torch.data.clip_embed import (
    ClipConfig,
    ClipEmbedder,
    clip_params_from_flax,
    hash_tokenize,
    produce_article_embeddings,
    write_embeddings_npz,
)

TOL = 1e-5
TEXTS = ["red wool sweater", "blue denim jacket", "red wool sweater", "", "a b c d e f g h",
         "Cotton SHIRT style 2"]


def _tiny_config(eos=511):
    from transformers import CLIPConfig, CLIPTextConfig, CLIPVisionConfig

    # bos/eos in-vocab: the text tower pools at the first position holding eos
    return CLIPConfig(
        text_config=CLIPTextConfig(
            vocab_size=512, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=77, bos_token_id=510,
            eos_token_id=eos).to_dict(),
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=2,
            image_size=32, patch_size=8).to_dict(),
        projection_dim=24,
    )


@pytest.fixture(scope="module")
def pair():
    """(JAX embedder in f32, the port's in f32 on the Flax weights, the
    port's in bf16 on the same weights)."""
    pytest.importorskip("transformers")
    import jax.numpy as jnp

    from laplace_gnn_recommendation_tpu.data import clip_embed as J

    cfg = _tiny_config()
    je = J.ClipEmbedder(config=cfg, batch_size=4, compute_dtype=jnp.float32)
    sd = clip_params_from_flax(je.model.params)
    te = ClipEmbedder(config=cfg, batch_size=4, compute_dtype=torch.float32, device="cpu",
                      state_dict=sd)
    tb = ClipEmbedder(config=cfg, batch_size=4, device="cpu", state_dict=sd)
    return je, te, tb


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("vocab,bos,eos", [(512, None, None), (49408, None, None),
                                           (512, 500, 501), (300, 1, 2)])
def test_hash_tokenize_equals_jax(vocab, bos, eos):
    from laplace_gnn_recommendation_tpu.data.clip_embed import hash_tokenize as jtok

    texts = TEXTS + ["ünïcode wörds " * 40]
    got = hash_tokenize(texts, vocab, bos=bos, eos=eos)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, jtok(texts, vocab, bos=bos, eos=eos))


def test_defaults_are_vit_b32():
    """The port's own copy of ``CLIPConfig()``'s defaults, field by field."""
    c = ClipConfig()
    assert (c.text_config.hidden_size, c.text_config.num_hidden_layers,
            c.text_config.num_attention_heads, c.text_config.intermediate_size,
            c.text_config.vocab_size, c.text_config.max_position_embeddings,
            c.text_config.bos_token_id, c.text_config.eos_token_id) == (
        512, 12, 8, 2048, 49408, 77, 49406, 49407)
    assert (c.vision_config.hidden_size, c.vision_config.num_hidden_layers,
            c.vision_config.num_attention_heads, c.vision_config.intermediate_size,
            c.vision_config.image_size, c.vision_config.patch_size) == (768, 12, 12, 3072, 224, 32)
    assert c.projection_dim == 512 and c.text_config.layer_norm_eps == 1e-5
    pytest.importorskip("transformers")
    from transformers import CLIPConfig

    assert ClipConfig.from_any(CLIPConfig()) == c


def test_text_features_match_jax(pair):
    je, te, _ = pair
    got, want = te.embed_texts(TEXTS), je.embed_texts(TEXTS)
    assert got.shape == (len(TEXTS), 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(got[0], got[2])
    assert not np.allclose(got[0], got[1])


def test_image_features_match_jax(pair):
    je, te, _ = pair
    imgs = _images(6)                      # 1.5 batches: the tail is padded
    got = te.embed_images(imgs)
    np.testing.assert_allclose(got, je.embed_images(imgs), rtol=0, atol=TOL)
    np.testing.assert_allclose(te.embed_images(imgs[5:6])[0], got[5], rtol=0, atol=TOL)
    # the device-side normalisation is the host preprocess_images' arithmetic
    np.testing.assert_array_equal(te.preprocess_images(imgs), je.preprocess_images(imgs))
    floats = imgs.astype(np.float32) / 255.0
    np.testing.assert_allclose(te.embed_images(floats), got, rtol=0, atol=TOL)


def test_eos_two_pools_at_argmax():
    """A config whose ``eos_token_id`` is 2 (the released checkpoints') pools
    at ``argmax(ids)``, as ``modeling_flax_clip.py`` does."""
    pytest.importorskip("transformers")
    import jax.numpy as jnp

    from laplace_gnn_recommendation_tpu.data import clip_embed as J

    cfg = _tiny_config(eos=2)
    je = J.ClipEmbedder(config=cfg, batch_size=4, compute_dtype=jnp.float32)
    te = ClipEmbedder(config=cfg, batch_size=4, compute_dtype=torch.float32, device="cpu",
                      state_dict=clip_params_from_flax(je.model.params))
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 400, (5, 77)).astype(np.int32)
    ids[np.arange(5), [4, 9, 20, 76, 1]] = 511          # the largest id: the eos
    tok = lambda texts: ids[: len(texts)]  # noqa: E731
    je._tokenize, te._tokenize = tok, tok
    np.testing.assert_allclose(te.embed_texts(["x"] * 5), je.embed_texts(["x"] * 5),
                               rtol=0, atol=TOL)


def test_bf16_close_to_f32(pair):
    _, te, tb = pair
    imgs = _images(5, seed=4)
    for a, b in ((tb.embed_texts(TEXTS), te.embed_texts(TEXTS)),
                 (tb.embed_images(imgs), te.embed_images(imgs))):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert (a * b).sum(1).min() >= 0.99


def test_npz_artifact_equals_jax(pair, tmp_path):
    je, te, _ = pair
    ids = [101, 102, 103, 104, 105, 106]
    imgs = _images(6, seed=1)
    for d in ("port", "jax"):
        os.makedirs(tmp_path / d)
    produce_article_embeddings(str(tmp_path / "port"), ids, texts=TEXTS, images=imgs,
                               embedder=te)
    from laplace_gnn_recommendation_tpu.data import clip_embed as J

    J.produce_article_embeddings(str(tmp_path / "jax"), ids, texts=TEXTS, images=imgs,
                                 embedder=je)
    for name in ("text_embeddings.npz", "image_embeddings.npz"):
        a, b = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
        assert sorted(a.files) == sorted(b.files) == sorted(map(str, ids))
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
    # the writers agree byte for byte on the same vectors
    v = te.embed_texts(TEXTS)
    write_embeddings_npz(str(tmp_path / "a.npz"), ids, v)
    J.write_embeddings_npz(str(tmp_path / "b.npz"), ids, v)
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()


def test_random_init_repeats_from_seed():
    cfg = ClipConfig(T.ClipTextConfig(vocab_size=64, hidden_size=16, intermediate_size=32,
                                      num_hidden_layers=1, num_attention_heads=2,
                                      bos_token_id=62, eos_token_id=63),
                     T.ClipVisionConfig(hidden_size=16, intermediate_size=32,
                                        num_hidden_layers=1, num_attention_heads=2,
                                        image_size=16, patch_size=8), projection_dim=8)
    a, b, c = (ClipEmbedder(config=cfg, batch_size=2, device="cpu", seed=s) for s in (0, 0, 1))
    sa, sb, sc = (e.model.state_dict() for e in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["text_projection.weight"], sc["text_projection.weight"])
    v = a.embed_texts(TEXTS)
    assert v.shape == (len(TEXTS), 8) and np.isfinite(v).all()
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-5)


def test_local_checkout_matches_transformers(tmp_path):
    """``weights=`` loads a local HuggingFace checkout through ``transformers``
    (``local_files_only``) and gives its PyTorch ``CLIPModel``'s features."""
    pytest.importorskip("transformers")
    from transformers import CLIPModel

    torch.manual_seed(0)
    hf = CLIPModel(_tiny_config()).eval()
    hf.save_pretrained(str(tmp_path / "ckpt"))
    tok = lambda texts: hash_tokenize(texts, 512, bos=510, eos=511)  # noqa: E731
    te = ClipEmbedder(weights=str(tmp_path / "ckpt"), batch_size=4, tokenizer=tok,
                      compute_dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(tok(TEXTS).astype(np.int64))
    eos = (ids == 511).int().argmax(1)
    mask = (torch.arange(77)[None] <= eos[:, None]).long()
    imgs = _images(3, seed=2)
    with torch.no_grad():
        want_t = torch.nn.functional.normalize(hf.get_text_features(ids, attention_mask=mask),
                                               dim=-1)
        want_i = torch.nn.functional.normalize(
            hf.get_image_features(torch.from_numpy(te.preprocess_images(imgs))), dim=-1)
    np.testing.assert_allclose(te.embed_texts(TEXTS), want_t.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(te.embed_images(imgs), want_i.numpy(), rtol=0, atol=TOL)


def test_artifact_feeds_fashion_preprocess(pair, tmp_path):
    """The port of ``tests/test_clip_embed.py``'s produce → consume case:
    the port's npz files through the port's ``preprocess_fashion``."""
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from laplace_gnn_recommendation_tpu_torch.configs import preprocessing_config
    from laplace_gnn_recommendation_tpu_torch.data import preprocess_fashion

    _, te, _ = pair
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(1)
    customers = pd.DataFrame({
        "customer_id": [f"c{i}" for i in range(5)], "postal_code": ["1", "1", "2", "2", "3"],
        "FN": [1.0, 0, 1.0, 0, 1.0], "age": [20, 30, 40, 20, 30],
        "club_member_status": ["ACTIVE"] * 5, "fashion_news_frequency": ["NONE"] * 5,
        "Active": [1.0] * 5,
    })
    customers.to_parquet(raw / "customers.parquet")
    raw_ids = [100 + i for i in range(6)]
    articles = pd.DataFrame({
        "article_id": raw_ids, "product_code": [1, 1, 2, 2, 3, 3],
        "product_type_no": [7, 7, 8, 8, 9, 9], "graphical_appearance_no": [5] * 6,
        "colour_group_code": [1, 2, 1, 2, 3, 3],
    })
    articles.to_parquet(raw / "articles.parquet")
    n_tx = 30
    pd.DataFrame({
        "customer_id": rng.choice(customers["customer_id"], n_tx),
        "article_id": rng.choice(articles["article_id"], n_tx),
        "price": rng.uniform(1, 10, n_tx),
        "t_dat": pd.to_datetime("2020-01-01") + pd.to_timedelta(np.arange(n_tx), unit="D"),
    }).to_parquet(raw / "transactions_train.parquet")
    texts = [f"article {r} cotton shirt style {r % 3}" for r in raw_ids]
    imgs = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    produce_article_embeddings(str(raw), raw_ids, texts=texts, images=imgs, embedder=te)
    pcfg = dataclasses.replace(preprocessing_config, load_image_embedding=True,
                               load_text_embedding=True)
    a = preprocess_fashion.preprocess(pcfg, str(raw), str(tmp_path / "derived"))
    ff = a.graph.node_features_float[NODE_ITEM]
    assert ff.shape == (a.graph.num_nodes[NODE_ITEM], 48) and np.isfinite(ff).all()
    prod = np.concatenate([te.embed_images(imgs), te.embed_texts(texts)], axis=1)
    for new_id, raw_id in a.article_id_map_forward.items():
        np.testing.assert_array_equal(ff[new_id], prod[raw_ids.index(int(raw_id))])
