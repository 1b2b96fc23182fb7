"""Dataset download + cache machinery (ref: python/paddle/v2/dataset/common.py
— DATA_HOME under ~/.cache, download(url, module, md5) with checksum verify,
re-download on mismatch).

Hermetic stance: every dataset in this package has a synthetic generator, so
nothing *requires* network; this module is the opt-in real-data path.  It
accepts any urllib-able URL (https, file:// — the latter is how tests exercise
it without egress) and verifies md5 before handing the file out.

The port's copy of ``paddle_tpu/datasets/common.py``; numpy only, sample for
sample the JAX package's."""
from __future__ import annotations

import hashlib
import os
import shutil
import urllib.request

from ..resilience import RetryPolicy, retry

DATA_HOME = os.environ.get("PADDLE_TPU_DATA_HOME",
                           os.path.expanduser("~/.cache/paddle_tpu"))

# the reference's retry-on-mismatch loop (v2/dataset/common.py download()) as
# a declarative policy: one refetch on corruption/transport error, brief pause
DOWNLOAD_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.2, max_delay_s=2.0)


def data_home() -> str:
    # env var re-read at call time so tests can monkeypatch it
    return os.environ.get("PADDLE_TPU_DATA_HOME", DATA_HOME)


def md5file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url: str, module: str, md5sum: str | None = None,
             save_name: str | None = None) -> str:
    """Fetch ``url`` into DATA_HOME/<module>/, verify md5, return the path.

    A cached file with the right checksum is returned without touching the
    network; a corrupt cache entry is re-downloaded once (the reference's
    retry-on-mismatch loop, v2/dataset/common.py download()).
    """
    d = os.path.join(data_home(), module)
    os.makedirs(d, exist_ok=True)
    fname = os.path.join(d, save_name or url.split("/")[-1])

    @retry(DOWNLOAD_RETRY)
    def fetch_verified() -> str:
        if os.path.exists(fname):
            if md5sum is None or md5file(fname) == md5sum:
                return fname
            os.remove(fname)  # corrupt cache — refetch
        tmp = fname + ".part"
        with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
            shutil.copyfileobj(r, f)
        os.replace(tmp, fname)
        if md5sum is not None and md5file(fname) != md5sum:
            raise IOError(f"md5 mismatch for {url} (expected {md5sum})")
        return fname

    return fetch_verified()


def cached_path(module: str, *names: str) -> str | None:
    """Path under DATA_HOME/<module>/ if every component exists, else None —
    how dataset loaders probe for opt-in real data."""
    p = os.path.join(data_home(), module, *names)
    return p if os.path.exists(p) else None


# ---- shared text-corpus machinery (imdb + sentiment real branches)

import re

WORD_RE = re.compile(r"[a-z0-9']+")


def file_tokens(path: str) -> list:
    """Lower-cased word tokens of a text file (one movie review etc.)."""
    with open(path, encoding="utf-8", errors="ignore") as f:
        return WORD_RE.findall(f.read().lower())


def freq_ranked_dict(paths, first_id: int = 0, max_size: int | None = None):
    """token -> id by descending corpus frequency, ids starting at
    ``first_id`` (the reference's build_dict-with-cutoff shape)."""
    from collections import Counter

    freq: Counter = Counter()
    for p in paths:
        freq.update(file_tokens(p))
    most = freq.most_common(max_size)
    return {w: first_id + i for i, (w, _) in enumerate(most)}
