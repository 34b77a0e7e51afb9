"""Boundaries of the port package (marlin_tpu_torch) and of chip_smoke.py.

* Neither imports JAX or the JAX package (``marlin_tpu``): the port keeps
  its own copy of what it needs. Proved statically (an AST scan of every
  import) and dynamically (importing the port in a fresh interpreter
  leaves ``jax`` out of ``sys.modules``).
* With CUDA absent, an entry point called without ``device="cpu"``
  raises instead of quietly running on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from marlin_tpu_torch.examples import transformer_lm
from marlin_tpu_torch.models import convert
from marlin_tpu_torch.models import transformer as pt
from marlin_tpu_torch.matrix import SparseVecMatrix
from marlin_tpu_torch.ops import BlockSparse, build
from marlin_tpu_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "marlin_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "marlin_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__"):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant) and isinstance(arg.value,
                                                                str):
                    yield arg.value


def test_no_port_file_imports_jax_or_the_jax_package():
    assert len(PORT_FILES) > 10
    offenders = []
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append(f"{path.relative_to(ROOT)}: {mod}")
    assert not offenders, offenders


def test_importing_the_port_pulls_in_no_jax():
    code = ("import sys\n"
            "import marlin_tpu_torch.serving, marlin_tpu_torch.models\n"
            "import marlin_tpu_torch.ops.flash_attention\n"
            "import marlin_tpu_torch.ops.block_sparse\n"
            "import marlin_tpu_torch.config, marlin_tpu_torch.matrix\n"
            "import marlin_tpu_torch.matrix.sparse\n"
            "import marlin_tpu_torch.utils.cost_model\n"
            "import marlin_tpu_torch.examples.transformer_lm\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',\n"
            "                                    'marlin_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_kernels_are_built_for_hopper_at_first_use_only():
    # Importing the package builds nothing; the build targets sm_90a
    # (wgmma and setmaxnreg exist only for the "a" target).
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    for name, src in build.SOURCES.items():
        assert src.is_file() and src.suffix == ".cu"
        assert build.library_path(name).parent == build.BUILD_DIR
    # Every CUDA source of the port is built: the flash forward and
    # backward and the block-sparse GEMM.
    assert set(build.SOURCES) == {p.stem for p in
                                  (ROOT / "marlin_tpu_torch" / "csrc")
                                  .glob("*.cu")}
    assert {"flash_attention_fwd", "flash_attention_bwd",
            "block_sparse"} <= set(build.SOURCES)


def test_library_path_follows_every_shared_header(tmp_path, monkeypatch):
    # The kernel sources include csrc/*.cuh (nvcc -I csrc): an edited or
    # an added header must rebuild every library, so it is part of each
    # library's name; an unchanged tree maps to the same library.
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    header = tmp_path / "h.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"k": src})
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    first = build.library_path("k")
    assert build.library_path("k") == first
    header.write_text("// two\n")
    assert build.library_path("k") != first
    header.write_text("// one\n")
    assert build.library_path("k") == first
    (tmp_path / "extra.cuh").write_text("")
    assert build.library_path("k") != first
    cmd = build.nvcc_command(src, tmp_path / "k.so", ptxas_verbose=True)
    assert cmd[0] == "nvcc" and cmd[-1] == str(src)
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)
    assert "-Xptxas=-v" in cmd and "arch=compute_90a,code=sm_90a" in cmd


@pytest.mark.parametrize("mangled, label", [
    ("_ZN55_GLOBAL__N__a0c445fd_22_flash_attention_fwd_cu_a8bdddc714"
     "flash_fwd_bf16ILi128ELi64EEEv14CUtensorMap_stS1_S1_P13__nv_bfloat16"
     "Pfiiiiii", "flash_fwd_bf16<128,64>"),
    ("_ZN55_GLOBAL__N__3b5507eb_22_flash_attention_bwd_cu_3005e98e16"
     "flash_bwd_dq_f32ILi64ELi128EEEvPKfS2_S2_S2_S2_S2_Pfiiiiiif",
     "flash_bwd_dq_f32<64,128>"),
    ("_Z3dbgILi128EEv14CUtensorMap_stS0_S0_PfS1_", "dbg<128>"),
    ("_Z6kernelPf", "kernel"),
    ("not_mangled", "not_mangled"),
])
def test_build_report_names_each_kernel(mangled, label):
    # chip_smoke.py's build phase prints ptxas's registers and spills per
    # kernel under a readable name (nvcc mangles the anonymous namespace
    # with a per-file tag).
    import chip_smoke

    assert chip_smoke._kernel_label(mangled) == label


def test_ops_exports_and_keeps_flash_attention_a_module():
    import types

    from marlin_tpu_torch import ops

    assert set(ops.__all__) == {"BlockSparse", "block_sparse_matmul"}
    # Callers import the module and read its launch counters; the JAX
    # package's ops/__init__ rebinds the name to the function instead.
    assert isinstance(ops.flash_attention, types.ModuleType)
    assert ops.flash_attention.launches >= 0


class TestNoSilentCpuFallback:
    @pytest.fixture(autouse=True)
    def _no_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("CUDA is present: the default device is valid here")

    def test_entry_points_default_to_cuda_and_raise(self):
        cfg = pt.TransformerConfig(vocab=32, d_model=16, n_heads=2,
                                   n_layers=1, d_ff=32, max_len=32)
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.init_params(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.init_kv_cache(cfg, 2)
        tree = _to_numpy(pt.init_params(cfg, device="cpu"))
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.params_from_jax(tree, cfg)
        params = pt.init_params(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(params, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            transformer_lm.main(["1", "2", "8", "64"])
        with pytest.raises(RuntimeError, match="CUDA"):
            BlockSparse.from_dense(np.ones((8, 8), np.float32), 8)
        with pytest.raises(RuntimeError, match="CUDA"):
            SparseVecMatrix.from_dense_array(np.eye(4))
        # Asked for explicitly, the CPU works.
        eng = ServingEngine(params, cfg, device="cpu")
        eng.submit(np.arange(3), 2)
        assert eng.run()[0].tokens.shape == (2,)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()
