"""Asset download CLI (counterpart of maniskill_tpu/utils/download_asset.py).

Downloads registered DataSources (utils/assets/data.py) into ASSET_DIR with
a sha256 check, unzipping archives (a zip with one root folder becomes the
target folder). Takes a single uid, an env id's data group, or ``all``.
Standard library only; ``huggingface_hub`` is imported only for the
sources that name a repo, and its absence is reported, not raised.

Usage:
    python -m maniskill_tpu_torch.utils.download_asset ycb
    python -m maniskill_tpu_torch.utils.download_asset PickSingleYCB-v1
    python -m maniskill_tpu_torch.utils.download_asset all [-y] [-o DIR] [--quiet]
"""
from __future__ import annotations

import argparse
import hashlib
import shutil
import sys
import tempfile
import urllib.request
import zipfile
from pathlib import Path

from .assets.data import ASSET_DIR, DATA_GROUPS, DATA_SOURCES


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("uid", help="data source id, env id (data group), or 'all'")
    p.add_argument("-y", "--yes", action="store_true", help="skip confirmation")
    p.add_argument("-o", "--output-dir", default=None)
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download_data_source(uid: str, output_dir=None, quiet=False) -> bool:
    src = DATA_SOURCES[uid]
    out_root = Path(output_dir) if output_dir else src.output_dir
    target = out_root / (src.target_path or uid)
    if target.exists():
        if not quiet:
            print(f"[{uid}] already present at {target}")
        return True
    url = src.url
    if url is None and src.hf_repo_id:
        try:
            from huggingface_hub import snapshot_download
        except ImportError:
            print(f"[{uid}] needs huggingface_hub for repo {src.hf_repo_id}")
            return False
        snapshot_download(
            repo_id=src.hf_repo_id, repo_type="dataset", local_dir=str(target)
        )
        return True
    if url is None:
        print(f"[{uid}] has no downloadable url")
        return False
    target.parent.mkdir(parents=True, exist_ok=True)
    if not quiet:
        print(f"[{uid}] downloading {url}")
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td) / (src.filename or url.rsplit("/", 1)[-1])
        urllib.request.urlretrieve(url, tmp)
        if src.checksum:
            got = _sha256(tmp)
            if got != src.checksum:
                print(f"[{uid}] checksum mismatch: {got} != {src.checksum}")
                return False
        if tmp.suffix == ".zip":
            with zipfile.ZipFile(tmp) as z:
                z.extractall(td)
            entries = [p for p in Path(td).iterdir() if p != tmp]
            roots = [p for p in entries if p.is_dir()]
            if len(roots) == 1:
                shutil.move(str(roots[0]), str(target))
            else:
                target.mkdir(parents=True, exist_ok=True)
                for e in entries:
                    shutil.move(str(e), str(target / e.name))
        else:
            shutil.move(str(tmp), str(target))
    if not quiet:
        print(f"[{uid}] -> {target}")
    return True


def main(argv=None):
    args = parse_args(argv)
    if args.uid == "all":
        uids = list(DATA_SOURCES)
    elif args.uid in DATA_SOURCES:
        uids = [args.uid]
    elif args.uid in DATA_GROUPS:
        uids = list(DATA_GROUPS[args.uid])
    else:
        print(
            f"unknown uid {args.uid!r}; known sources: {sorted(DATA_SOURCES)}; "
            f"groups: {sorted(DATA_GROUPS)}"
        )
        return 1
    if not args.yes:
        reply = input(f"download {len(uids)} asset(s) to {ASSET_DIR}? [y/N] ")
        if reply.strip().lower() not in ("y", "yes"):
            return 0
    ok = all(
        download_data_source(u, output_dir=args.output_dir, quiet=args.quiet)
        for u in uids
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
