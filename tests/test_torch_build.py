"""An installed copy of the port can build its kernels: every header the
CUDA sources include ships with the package, and the build directory falls
back to a per-user cache where the checkout's cannot be written."""

import ast
import fnmatch
import re
from pathlib import Path

import pytest

from recnet_tpu_torch.ops.cuda import build

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "recnet_tpu_torch" / "csrc"


def _package_data():
    """setup.py's package_data for recnet_tpu_torch, read without running
    setup()."""
    tree = ast.parse((REPO / "setup.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.keyword) and node.arg == "package_data":
            return ast.literal_eval(node.value)["recnet_tpu_torch"]
    raise AssertionError("setup.py has no package_data")


def test_every_included_header_ships_with_the_package():
    globs = _package_data()
    sources = sorted(CSRC.glob("*.cu"))
    assert sources
    shipped = lambda rel: any(fnmatch.fnmatch(rel, g) for g in globs)
    for src in sources:
        assert shipped(f"csrc/{src.name}"), src.name
        for name in re.findall(r'#include\s+"([^"]+)"', src.read_text()):
            assert (CSRC / name).is_file(), f"{src.name} includes {name}"
            assert shipped(f"csrc/{name}"), (
                f"{src.name} includes {name}, which package_data misses")


def test_the_train_console_script_is_declared():
    text = (REPO / "setup.py").read_text()
    assert "recnet-torch-train = recnet_tpu_torch.cli.train:main" in text


@pytest.mark.parametrize("script,module", [
    ("recnet-torch-split", "split"), ("recnet-torch-bundle", "bundle"),
    ("recnet-torch-import", "import_torch"),
    ("recnet-torch-export", "export_torch")])
def test_the_data_console_scripts_are_declared(script, module):
    text = (REPO / "setup.py").read_text()
    assert f"{script} = recnet_tpu_torch.cli.{module}:main" in text


def test_the_metrics_core_ships_and_builds_beside_the_kernels():
    """native/*.cpp ships with the package, and the built module goes to
    the build directory the kernels use."""
    from recnet_tpu_torch import native
    sources = sorted((REPO / "recnet_tpu_torch" / "native").glob("*.cpp"))
    assert sources
    for src in sources:
        assert any(fnmatch.fnmatch(f"native/{src.name}", g)
                   for g in _package_data()), src.name
    assert native.library_path().parent == build.build_dir()


@pytest.fixture
def fresh_build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", None)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return tmp_path


def test_build_dir_is_the_checkouts_when_writable(fresh_build_dir,
                                                  monkeypatch):
    root = fresh_build_dir / "checkout"
    root.mkdir()
    (root / "setup.py").write_text("")
    monkeypatch.setattr(build, "CHECKOUT_ROOT", root)
    assert build.build_dir() == root / "build" / "recnet_tpu_torch"
    assert build.build_dir().is_dir()


@pytest.mark.parametrize("layout", ["read_only", "installed"])
def test_build_dir_falls_back_to_the_user_cache(fresh_build_dir,
                                                monkeypatch, layout):
    root = fresh_build_dir / "checkout"
    root.mkdir()
    if layout == "read_only":
        (root / "setup.py").write_text("")
        # a file where the build directory would go: no user, root
        # included, can create the directory
        (root / "build").write_text("")
    monkeypatch.setattr(build, "CHECKOUT_ROOT", root)
    got = build.build_dir()
    assert got == fresh_build_dir / "cache" / "recnet_tpu_torch"
    lib = build.library_path("whole_decode")
    assert lib.parent == got
    got.mkdir(parents=True, exist_ok=True)
    (got / "probe").write_text("ok")          # writable


def test_build_error_names_the_build_directory(fresh_build_dir,
                                               monkeypatch):
    monkeypatch.setattr(build, "CHECKOUT_ROOT", fresh_build_dir / "none")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(fresh_build_dir / "none"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME",
                        str(fresh_build_dir / "none"))
    monkeypatch.setattr(build, "_libraries", {})
    with pytest.raises(build.BuildError,
                       match=str(fresh_build_dir / "cache")):
        build.load("whole_decode")
