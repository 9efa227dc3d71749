"""Hugging Face hub upload of a folder in chunks, a dataset repo.

A copy of ``stable_diffusion_videos_tpu/hub.py``: ``huggingface_hub`` is
imported when an upload starts, so the package imports without it.
"""

from __future__ import annotations

import logging
from pathlib import Path

logger = logging.getLogger("sdv_torch")


def get_all_files(root: Path):
    """Depth-first iterator over all files under ``root``."""
    stack = [Path(root)]
    while stack:
        d = stack.pop()
        for p in d.iterdir():
            if p.is_file():
                yield p
            elif p.is_dir():
                stack.append(p)


def get_groups_of_n(n: int, iterator):
    """Chunk any iterator into lists of at most ``n`` items."""
    if n < 1:
        raise ValueError("n must be >= 1")
    buf = []
    for item in iterator:
        buf.append(item)
        if len(buf) == n:
            yield buf
            buf = []
    if buf:
        yield buf


def upload_folder_chunked(repo_id: str, upload_dir, n: int = 100,
                          private: bool = False, create_pr: bool = False):
    """Upload a folder to the hub as a dataset repo, ``n`` files a commit
    (thousands of frames never go in one commit)."""
    from huggingface_hub import (CommitOperationAdd, create_commit,
                                 create_repo)
    root = Path(upload_dir)
    if not root.exists():
        raise ValueError(f"Upload directory {root} does not exist.")
    url = create_repo(repo_id, exist_ok=True, private=private,
                      repo_type="dataset")
    logger.info("uploading files to %s", url)
    for i, files in enumerate(get_groups_of_n(n, get_all_files(root))):
        ops = [CommitOperationAdd(
            path_in_repo=f"{f.parent.name}/{f.name}", path_or_fileobj=str(f))
            for f in files]
        create_commit(repo_id=repo_id, operations=ops,
                      commit_message=f"Upload part {i}", repo_type="dataset",
                      create_pr=create_pr)
        logger.info("committed chunk %d (%d files)", i, len(files))
