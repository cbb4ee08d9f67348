"""Dataset download helpers — the port's copy of the JAX package's
``data/download.py`` (reference ``run_download_data.py:8-34``).

Uses urllib instead of ``os.system('wget ...')`` shell-outs. H&M parquet
files come from a private host configured via ``DATA_HOST_URL`` (as in the
reference); MovieLens-1M from grouplens. In egress-less environments these
raise immediately — use :mod:`.synthetic` generators instead.
"""
from __future__ import annotations

import os
import urllib.request
import zipfile

MOVIELENS_URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"


def download_movielens(raw_dir: str = "data/original") -> None:
    os.makedirs(raw_dir, exist_ok=True)
    zip_path = os.path.join(raw_dir, "ml-1m.zip")
    if not os.path.exists(os.path.join(raw_dir, "ratings.dat")):
        urllib.request.urlretrieve(MOVIELENS_URL, zip_path)
        with zipfile.ZipFile(zip_path) as z:
            z.extractall(raw_dir)
        inner = os.path.join(raw_dir, "ml-1m")
        if os.path.isdir(inner):
            for name in os.listdir(inner):
                os.replace(os.path.join(inner, name), os.path.join(raw_dir, name))
            os.rmdir(inner)
        os.remove(zip_path)


def download_fashion(raw_dir: str = "data/original") -> None:
    host = os.environ.get("DATA_HOST_URL")
    if not host:
        raise RuntimeError("DATA_HOST_URL not set (private H&M data host)")
    os.makedirs(raw_dir, exist_ok=True)
    for name in ("customers.parquet", "articles.parquet", "transactions_splitted.parquet"):
        dest = os.path.join(raw_dir, name)
        if not os.path.exists(dest):
            urllib.request.urlretrieve(f"{host}/{name}", dest)
