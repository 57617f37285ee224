"""Download/cache plumbing shared by the dataset fetchers.

Counterpart of ``lightfm_tpu/datasets/_common.py``.

Behavioral parity target: ``lightfm/datasets/_common.py`` — fetchers cache
downloads under ``~/lightfm_data`` (or an explicit ``data_home``) and raise
``IOError`` when the file is absent and downloading is disabled.  Built on
``pathlib`` + ``urllib`` (no ``requests`` dependency), with atomic
``.part``-rename downloads so an interrupted fetch never leaves a corrupt
cache entry.
"""

from __future__ import annotations

import os
import urllib.request
from pathlib import Path


def get_data_dir() -> str:
    """Root of the local dataset cache (shared with the reference's layout)."""
    return str(Path.home() / "lightfm_data")


def create_data_dir(path) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)


def download(url: str, dest_path) -> None:
    """Stream ``url`` to ``dest_path`` atomically (write .part, then rename)."""
    dest = Path(dest_path)
    tmp = dest.with_name(dest.name + ".part")
    with urllib.request.urlopen(url) as resp, open(tmp, "wb") as fd:
        while True:
            chunk = resp.read(2**20)
            if not chunk:
                break
            fd.write(chunk)
    os.replace(tmp, dest)


def get_data(
    data_home,
    url: str,
    dest_subdir: str,
    dest_filename: str,
    download_if_missing: bool,
) -> str:
    """Return the local path of a cached dataset file, downloading on miss."""
    root = Path(data_home).resolve() if data_home is not None else Path(get_data_dir())
    dest = root / dest_subdir / dest_filename
    dest.parent.mkdir(parents=True, exist_ok=True)

    if not dest.is_file():
        if not download_if_missing:
            raise IOError("Dataset missing.")
        download(url, dest)

    return str(dest)
