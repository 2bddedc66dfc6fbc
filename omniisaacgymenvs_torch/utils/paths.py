"""Checkpoint path resolution, with remote checkpoints cached locally.

`checkpoint=` takes a local path or an http(s):// URL of a .tar.gz / .tgz /
.tar / .zip archive of one checkpoint directory. The archive is fetched
once into `checkpoints/`, unpacked under `checkpoints/<archive stem>/`, and
used from there on later runs. Downloads and unpacking go to `.part` names
and are renamed into place only when they succeed, so a cut download or a
corrupt archive does not poison the cache (a corrupt archive is deleted,
and the next attempt fetches it again).
"""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import urllib.request
import zipfile

CACHE_DIR = "checkpoints"
ARCHIVE_SUFFIXES = (".tar.gz", ".tgz", ".tar", ".zip")


def _unpacked_root(extract_dir: str) -> str:
    """The checkpoint directory inside an unpacked archive: the archive's
    one top-level directory if it has one (`tar czf ckpt.tar.gz ckpt/`)."""
    entries = [e for e in os.listdir(extract_dir) if not e.startswith(".")]
    if len(entries) == 1:
        inner = os.path.join(extract_dir, entries[0])
        if os.path.isdir(inner):
            return inner
    return extract_dir


def retrieve_checkpoint_path(path: str) -> str:
    """Local paths pass through; an http(s):// archive URL is downloaded to
    checkpoints/ once, and the unpacked directory's path is returned."""
    if not path.startswith(("http://", "https://")):
        return path
    fname = os.path.basename(path.split("?", 1)[0])
    suffix = next((s for s in ARCHIVE_SUFFIXES if fname.endswith(s)), None)
    if suffix is None:
        raise ValueError(
            f"a remote checkpoint must be a {'/'.join(ARCHIVE_SUFFIXES)} archive "
            f"of a checkpoint directory: {path}")
    extract_dir = os.path.join(CACHE_DIR, fname[:-len(suffix)])
    if os.path.isdir(extract_dir) and os.listdir(extract_dir):
        return _unpacked_root(extract_dir)  # cached by an earlier run

    os.makedirs(CACHE_DIR, exist_ok=True)
    archive = os.path.join(CACHE_DIR, fname)
    if not os.path.exists(archive):
        tmp_archive = archive + ".part"
        print(f"downloading checkpoint {path} -> {archive}")
        try:
            urllib.request.urlretrieve(path, tmp_archive)
            os.replace(tmp_archive, archive)
        finally:
            if os.path.exists(tmp_archive):
                os.remove(tmp_archive)
    tmp_extract = extract_dir + ".part"
    shutil.rmtree(tmp_extract, ignore_errors=True)
    os.makedirs(tmp_extract)
    try:
        if suffix == ".zip":
            with zipfile.ZipFile(archive) as z:
                z.extractall(tmp_extract)
        else:
            with tarfile.open(archive) as t:
                t.extractall(tmp_extract, filter="data")
        os.replace(tmp_extract, extract_dir)
    except (tarfile.TarError, zipfile.BadZipFile, gzip.BadGzipFile, EOFError):
        # a corrupt archive: drop it, so that the next attempt fetches it anew
        os.remove(archive)
        raise
    finally:
        shutil.rmtree(tmp_extract, ignore_errors=True)
    return _unpacked_root(extract_dir)
