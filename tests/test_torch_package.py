"""Package-level contracts of the PyTorch/CUDA port: it imports neither
JAX nor the JAX package, it never picks the CPU quietly, its kernel
sources and build are in place, and chip_smoke.py refuses to run where
there is no card or no checkout."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import slate_tpu_torch as pst  # noqa: E402
from slate_tpu_torch.internal import _build  # noqa: E402
import tests.torch_cpu_threads  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "slate_tpu_torch"


def test_import_pulls_in_no_jax():
    code = ("import sys, slate_tpu_torch\n"
            "import slate_tpu_torch.internal.comm\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'slate_tpu' or "
            "m.startswith('slate_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_source_names_no_jax_and_no_slate_tpu():
    pat = re.compile(r"^\s*(import|from)\s+jax\b|\bslate_tpu\.", re.M)
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in sorted(PKG.rglob("*.py"))
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_grid_never_picks_the_cpu_quietly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(pst.SlateError, match="device='cpu'"):
        pst.Grid(1, 1)
    with pytest.raises(pst.SlateError):
        pst.Matrix.from_dense([[1.0]], nb=1)
    g = pst.Grid(1, 1, device="cpu")
    assert g.device == torch.device("cpu") and g.size == 1
    assert (g.tile_owner(5, 3), g.tile_slot(5, 3)) == ((0, 0), (5, 3))


def test_kernel_sources_and_build_key():
    names = [s.name for s in _build._sources()]
    assert names == ["band_chase.cu", "hb2st_chase.cu", "lu_nopiv_tile.cu",
                     "panel_plu.cu",
                     "panel_plu_swap.cu", "panel_qr.cu", "panel_transpose.cu",
                     "potrf_tile.cu", "rank_k_tail.cu", "stein_tridiag.cu",
                     "trsm_left.cu", "trsm_lower.cu"]
    for src in _build._sources():
        text = src.read_text()
        assert "extern \"C\" int slate_" in text
        assert "cudaGetLastError" in text
    key = _build._digest()
    assert key == _build._digest() and len(key) == 16
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "slate_tpu_torch/_build/" in ignored


def test_build_without_nvcc_raises(monkeypatch):
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(pst.SlateError, match="nvcc"):
        _build.build()


def test_exports():
    for name in ("Grid", "Matrix", "HermitianMatrix", "TriangularMatrix",
                 "transpose", "conj_transpose", "potrf", "potrs", "posv",
                 "gemm", "trsm", "multiply", "chol_factor", "chol_solve",
                 "chol_solve_using_factor", "from_reference", "to_reference",
                 "finite_guard", "info_merge", "zero_nonfinite", "SlateError",
                 "InfoError", "raise_if_info", "Option", "get_option",
                 "getrf", "getrs", "gesv", "PivotOrder", "MethodLU",
                 "pivot_order_to_ipiv", "lu_factor", "lu_solve",
                 "lu_solve_using_factor", "pivots_from_reference",
                 "pivots_to_reference", "getrf_nopiv", "getrs_nopiv",
                 "gesv_nopiv", "geqrf", "unmqr", "gelqf", "unmlq", "cholqr",
                 "gels", "herk", "syrk", "MethodGels", "lu_factor_nopiv",
                 "lu_solve_nopiv", "lu_solve_using_factor_nopiv",
                 "least_squares_solve", "qr_factor", "lq_factor",
                 "qr_multiply_by_q", "lq_multiply_by_q",
                 "t_factors_from_reference", "t_factors_to_reference",
                 "heev", "sterf", "steqr", "stedc", "gesvd", "he2hb", "ge2tb",
                 "eig_vals", "eig", "svd_vals", "svd", "MethodEig",
                 "MethodSVD", "band_from_reference", "band_to_reference",
                 "reflectors_from_reference", "reflectors_to_reference",
                 "BandMatrix", "BandLUFactor", "gbtrf", "gbtrs", "gbsv",
                 "hetrf", "hetrs", "hesv", "indefinite_factor",
                 "indefinite_solve", "indefinite_solve_using_factor",
                 "band_lu_from_reference", "band_lu_to_reference",
                 "hetrf_from_reference", "hetrf_to_reference",
                 "gesv_mixed", "posv_mixed", "gesv_mixed_gmres",
                 "posv_mixed_gmres", "norm", "col_norms", "NormScope", "add",
                 "copy", "scale", "scale_row_col", "set_matrix", "gecondest",
                 "pocondest", "trcondest", "trtri", "trtrm", "potri", "getri",
                 "lu_inverse_using_factor",
                 "lu_inverse_using_factor_out_of_place",
                 "chol_inverse_using_factor", "HealthReport",
                 "health_report", "recent_reports", "TrapezoidMatrix",
                 "SymmetricMatrix", "TriangularBandMatrix",
                 "HermitianBandMatrix", "her2k", "syr2k", "hemm", "symm",
                 "trmm", "gbmm", "hbmm", "tbsm", "pbtrf", "pbtrs", "pbsv",
                 "hegst", "hegv", "triangular_multiply", "triangular_solve",
                 "rank_k_update", "rank_2k_update", "BandCholFactor",
                 "band_chol_from_reference", "band_chol_to_reference",
                 "lapack_api", "default_grid", "getrf_tntpiv",
                 "getrf_dense_inplace", "potrf_dense_inplace"):
        assert hasattr(pst, name), name


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
