"""The port's asset registry, download CLI and URDF generators against the
JAX package's, on the CPU and with no network.

- ``DATA_SOURCES`` and ``DATA_GROUPS`` equal the JAX package's field by field
  (url, repo, target path, checksum, ...), each ``output_dir`` under the
  same ``MS_ASSET_DIR`` rule; group expansion, ``expected_assets_for_env``
  and ``is_data_group_downloaded`` agree.
- ``download_asset.main`` of each package against ``file://`` zips written
  to ``tmp_path``: a good one with its checksum, a bad checksum (rc 1,
  nothing written), a single-root zip (its root becomes the target), a
  flat zip, a zip of one folder beside loose files (mirrored: the loose
  files are dropped), an already present target, an unknown uid (rc 1), a group, and
  the prompt answered "n" (rc 0, nothing written). Both packages leave the
  same files.
- The five URDF generators, run in a copy of ``assets/robots``, rewrite the
  port's URDFs byte for byte.
"""
import builtins
import dataclasses
import filecmp
import hashlib
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

from maniskill_tpu.utils import download_asset as jdl
from maniskill_tpu.utils.assets import data as jdata

from maniskill_tpu_torch import PACKAGE_ASSET_DIR
from maniskill_tpu_torch.utils import download_asset as tdl
from maniskill_tpu_torch.utils.assets import data as tdata

GENERATORS = ["ability_hand/generate.py", "inspire_hand/generate.py", "stompy/generate.py",
              "unitree_g1/generate_g1.py", "unitree_h1/generate_h1_hands.py"]


def test_registry_matches_reference():
    assert tdata.ASSET_DIR == jdata.ASSET_DIR
    assert list(tdata.DATA_SOURCES) == list(jdata.DATA_SOURCES)
    assert len(tdata.DATA_SOURCES) > 100, "the per-model PartNet-Mobility sources are missing"
    for uid, j in jdata.DATA_SOURCES.items():
        t = dataclasses.asdict(tdata.DATA_SOURCES[uid])
        j = dataclasses.asdict(j)
        assert t.pop("output_dir").relative_to(tdata.ASSET_DIR) == j.pop("output_dir").relative_to(jdata.ASSET_DIR)
        assert t == j, uid
    assert tdata.DATA_GROUPS == jdata.DATA_GROUPS
    for group in list(jdata.DATA_GROUPS) + ["no-such-group"]:
        assert (tdata.expand_data_group_into_individual_data_source_ids(group)
                == jdata.expand_data_group_into_individual_data_source_ids(group)), group
        assert tdata.expected_assets_for_env(group) == jdata.expected_assets_for_env(group)
    assert len(tdata.DATA_GROUPS["partnet_mobility_cabinet_models"]) > 0


def _zip(path: Path, files: dict) -> str:
    with zipfile.ZipFile(path, "w") as z:
        for name, text in files.items():
            z.writestr(name, text)
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture
def sources(tmp_path):
    """Temporary file:// sources and a group in both registries, removed
    after the test: (output dir of each package, the uids)."""
    zips = tmp_path / "zips"
    zips.mkdir()
    root_sha = _zip(zips / "rooted.zip", {"pack/a.txt": "a", "pack/sub/b.txt": "b"})
    flat_sha = _zip(zips / "flat.zip", {"x.txt": "x", "w.txt": "w"})
    mixed_sha = _zip(zips / "mixed.zip", {"x.txt": "x", "y/z.txt": "z"})
    specs = {
        "t_rooted": dict(url=f"file://{zips}/rooted.zip", target_path="tasks/rooted", checksum=root_sha),
        "t_flat": dict(url=f"file://{zips}/flat.zip", target_path="tasks/flat", checksum=flat_sha),
        "t_mixed": dict(url=f"file://{zips}/mixed.zip", target_path="tasks/mixed", checksum=mixed_sha),
        "t_bad": dict(url=f"file://{zips}/flat.zip", target_path="tasks/bad", checksum="0" * 64),
        "t_nourl": dict(target_path="tasks/nourl"),
    }
    outs = {}
    for name, data in (("jax", jdata), ("port", tdata)):
        outs[name] = tmp_path / name
        for uid, kw in specs.items():
            data.register_data_source(uid, source_type="task_assets", output_dir=outs[name], **kw)
        data.DATA_GROUPS["T-Group-v1"] = ["t_rooted", "t_flat"]
    yield outs
    for data in (jdata, tdata):
        for uid in specs:
            data.DATA_SOURCES.pop(uid, None)
        data.DATA_GROUPS.pop("T-Group-v1", None)


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")) if root.exists() else []


def test_download_asset_matches_reference(sources, monkeypatch, capsys):
    for name, dl in (("jax", jdl), ("port", tdl)):
        out = sources[name]
        assert dl.main(["t_rooted", "-y", "--quiet"]) == 0
        assert (out / "tasks/rooted/a.txt").read_text() == "a"
        assert (out / "tasks/rooted/sub/b.txt").read_text() == "b"
        assert dl.main(["t_flat", "-y", "--quiet"]) == 0
        assert _files(out / "tasks/flat") == ["w.txt", "x.txt"]
        # one folder beside loose files is taken for the single root, and the
        # loose files are dropped, in both packages (ROADMAP.md section 3)
        assert dl.main(["t_mixed", "-y", "--quiet"]) == 0
        assert _files(out / "tasks/mixed") == ["z.txt"]
        assert dl.main(["t_bad", "-y", "--quiet"]) == 1
        assert not (out / "tasks/bad").exists()
        assert dl.main(["t_nourl", "-y", "--quiet"]) == 1
        assert dl.main(["no_such_uid", "-y"]) == 1
        monkeypatch.setattr(builtins, "input", lambda prompt: "n")
        shutil.rmtree(out / "tasks")
        assert dl.main(["T-Group-v1"]) == 0
        assert not (out / "tasks").exists()
        monkeypatch.setattr(builtins, "input", lambda prompt: "y")
        assert dl.main(["T-Group-v1"]) == 0
        assert dl.main(["t_rooted", "-y"]) == 0  # already present
        other = out.parent / f"{name}_o"
        assert dl.main(["t_flat", "-y", "--quiet", "-o", str(other)]) == 0
        assert _files(other) == ["tasks", "tasks/flat", "tasks/flat/w.txt", "tasks/flat/x.txt"]
    assert _files(sources["port"]) == _files(sources["jax"])
    text = capsys.readouterr().out
    assert "checksum mismatch" in text and "unknown uid 'no_such_uid'" in text and "already present" in text


def test_is_data_group_downloaded_matches_reference(sources):
    for name, data in (("jax", jdata), ("port", tdata)):
        assert not data.is_data_group_downloaded("T-Group-v1")
        (sources[name] / "tasks/rooted").mkdir(parents=True)
        assert not data.is_data_group_downloaded("T-Group-v1")
        (sources[name] / "tasks/flat").mkdir(parents=True)
        assert data.is_data_group_downloaded("T-Group-v1")
        assert data.DATA_SOURCES["t_flat"].is_downloaded()
        assert data.DATA_SOURCES["t_flat"].path == sources[name] / "tasks/flat"


def test_urdf_generators_rewrite_the_port_urdfs(tmp_path):
    """Each generator, run in place in a copy of the port's robots tree,
    rewrites the URDFs the port carries byte for byte (two of them read or
    write a sibling folder, so the whole tree is copied)."""
    src = Path(PACKAGE_ASSET_DIR) / "robots"
    work = tmp_path / "robots"
    shutil.copytree(src, work)
    for urdf in work.rglob("*.urdf"):
        os.utime(urdf, (0, 0))
    for gen in GENERATORS:
        path = work / gen
        subprocess.run([sys.executable, path.name], cwd=path.parent, check=True, capture_output=True)
    regenerated = {str(p.relative_to(work)) for p in work.rglob("*.urdf") if p.stat().st_mtime > 0}
    assert regenerated >= {"ability_hand/ability_hand_right_floating.urdf", "xarm7/xarm7_ability.urdf",
                           "inspire_hand/inspire_hand_left.urdf", "stompy/stompy.urdf",
                           "unitree_g1/g1.urdf", "unitree_h1/h1_with_hand.urdf"}
    for rel in sorted(regenerated):
        assert filecmp.cmp(work / rel, src / rel, shallow=False), rel
