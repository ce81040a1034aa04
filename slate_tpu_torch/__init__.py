"""slate_tpu_torch — the PyTorch/CUDA port of the JAX package.

Tiled matrices in the same 2-D block-cyclic layout as ``slate_tpu``, the
Cholesky solve path (``potrf`` → ``potrs`` → ``posv``), the LU solve
with partial pivoting (``getrf`` → ``getrs`` → ``gesv``) and without
(``getrf_nopiv`` → ``getrs_nopiv`` → ``gesv_nopiv``), least squares
through QR (``geqrf`` → ``unmqr`` → ``gels``, with ``gelqf``/``unmlq``
and ``cholqr``), the band LU solve (``gbtrf`` → ``gbtrs`` → ``gbsv``),
the symmetric-indefinite solve by Aasen (``hetrf`` → ``hetrs`` →
``hesv``), the two-stage symmetric eigensolver and SVD
(``heev`` = ``he2hb`` → ``hb2st`` → ``sterf``/``stedc``, ``gesvd`` =
``ge2tb`` → ``tb2bd`` → ``bdsqr``, with their back-transforms), the
mixed-precision solves (``gesv_mixed``, ``posv_mixed`` and their
GMRES-IR forms) with the three trailing-update precision tiers, norms,
elementwise ops, condition estimates, ``health=True`` reports and the
inverses (``trtri``, ``potri``, ``getri``), the rest of Level-3 BLAS
(``hemm``, ``symm``, ``her2k``, ``syr2k``, ``trmm``), the band BLAS
(``gbmm``, ``hbmm``, ``tbsm``), the band Cholesky (``pbtrf`` → ``pbtrs``
→ ``pbsv``) and the generalised eigensolver (``hegst``, ``hegv``) on one
device. Its tile,
panel and bulge-chase ops run hand-written CUDA kernels for Hopper
(sm_90a) on the card, built with ``nvcc`` at first use (``csrc/``), and
their plain PyTorch versions on the CPU.

The solvers, the two-stage eigensolver and SVD included, take float32,
float64, complex64 and complex128. The tile and panel kernels take real
dtypes, as the Pallas kernels of the JAX package do: the capability
table sends complex to the ``torch.linalg``, cuBLAS and cuSOLVER ops,
as the JAX package sends it to XLA; the bulge chases K8/K9 take all
four types.

Entry points run on the CUDA card unless the caller asks for the CPU:
``Grid(1, 1)`` means ``torch.device("cuda")`` and raises without one;
``Grid(1, 1, device="cpu")`` runs on the CPU. ``Grid(p, q)`` holds p·q
virtual ranks on that one device, the tiles rank-stacked in the JAX
package's block-cyclic layout, every cross-rank read through the
collectives of ``internal/comm.py``. On it run the Cholesky and LU
solves (with and without pivoting, in super-step chunks), QR/LQ and
least squares, the two-stage eigensolver and SVD with ``hegst``/
``hegv``, the dense Level-3 BLAS, the norms, the elementwise ops and
the generator, the inverses, condition estimates and ``health=True``
reports, the mixed-precision solves, Aasen's ``hetrf``/``hetrs``/
``hesv``, and the band factorizations and band BLAS (``gbtrf``/
``gbtrs``/``gbsv``, ``pbtrf``/``pbtrs``/``pbsv``, ``gbmm``, ``hbmm``,
``tbsm``: the band packed from every rank, the one-rank packed loop run
once, B, C and X put back over their grid's block-cyclic map, so their
outputs are those of Grid(1, 1) bit for bit). No entry point refuses a
p×q grid.

Serving (``serve/``): the batched drivers ``batched_potrf``,
``batched_posv``, ``batched_getrf``, ``batched_gesv``, ``batched_trsm``
(with ``posv_batched``/``gesv_batched``) run a ``[batch, n, n]`` stack
on one device, K1 factoring each diagonal block of the whole stack in
one launch, with per-member pivots and ``info``; ``solve_ragged`` packs
mixed-order requests into the bucket table of ``cache/buckets.py`` and
runs them as power-of-two batches, with per-request health reports, the
serving metrics of ``obs/`` and the fault injection of
``robust/faults.py``.

The test-matrix generator, printing and debug aids are in ``utils/``
and the version stamp in ``version.py``, as in the JAX package.

This package imports torch, numpy and the standard library only, never
JAX or ``slate_tpu``.
"""

from .version import __version__, version, id  # noqa: A004

from .types import (Op, Uplo, Diag, Side, Norm, NormScope, Option,
                    GridOrder, MethodGemm, MethodLU, MethodGels, MethodEig,
                    MethodSVD, get_option, superstep_chunk)
from .errors import SlateError, InfoError, slate_error_if, raise_if_info
from .grid import Grid, default_grid
from .matrix import (
    BaseTiledMatrix, Matrix, HermitianMatrix, TriangularMatrix, BandMatrix,
    TrapezoidMatrix, SymmetricMatrix, TriangularBandMatrix,
    HermitianBandMatrix, transpose, conj_transpose, cdiv, bc_from_tiles, bc_to_tiles,
    dense_to_tiles, tiles_to_dense,
)
from .robust.guards import (finite_guard, info_merge, zero_nonfinite,
                            HealthReport, health_report, recent_reports)
from .internal import kernels
from .ops.blas import (gemm, herk, syrk, trsm, her2k, syr2k, hemm, symm,
                       trmm, gbmm, hbmm, tbsm)
from .ops.norms import norm, col_norms
from .ops.elementwise import add, copy, scale, scale_row_col, set_matrix
from .linalg.potrf import (potrf, potrs, posv, pbtrf, pbtrs, pbsv,
                           potrf_dense_inplace, posv_batched)
from .linalg.getrf import (getrf, getrs, gesv, PivotOrder,
                           pivot_order_to_ipiv, getrf_nopiv, getrs_nopiv,
                           gesv_nopiv, gbtrf, gbtrs, gbsv, getrf_tntpiv,
                           getrf_dense_inplace, gesv_batched)
from .linalg.band import BandLUFactor, BandCholFactor
from .linalg.hetrf import hetrf, hetrs, hesv
from .linalg.geqrf import geqrf, unmqr, gelqf, unmlq, cholqr, gels
from .linalg.eig import heev, hegst, hegv, sterf, steqr, stedc
from .linalg.he2hb import he2hb
from .linalg.ge2tb import ge2tb
from .linalg.svd import gesvd
from .linalg.mixed import (gesv_mixed, posv_mixed, gesv_mixed_gmres,
                           posv_mixed_gmres)
from .linalg.condest import gecondest, pocondest, trcondest
from .linalg.trtri import trtri, trtrm, potri, getri
from .simplified import (multiply, triangular_multiply, triangular_solve,
                         rank_k_update, rank_2k_update, chol_factor, chol_solve,
                         chol_solve_using_factor, lu_factor, lu_solve,
                         lu_solve_using_factor, lu_inverse_using_factor,
                         lu_inverse_using_factor_out_of_place,
                         chol_inverse_using_factor, lu_factor_nopiv,
                         lu_solve_nopiv, lu_solve_using_factor_nopiv,
                         indefinite_factor, indefinite_solve,
                         indefinite_solve_using_factor, least_squares_solve, qr_factor, lq_factor,
                         qr_multiply_by_q, lq_multiply_by_q, eig_vals, eig,
                         svd_vals, svd)
from .interop import (from_reference, to_reference, pivots_from_reference,
                      pivots_to_reference, t_factors_from_reference,
                      t_factors_to_reference, band_from_reference,
                      band_to_reference, reflectors_from_reference,
                      reflectors_to_reference, band_lu_from_reference,
                      band_lu_to_reference, hetrf_from_reference,
                      hetrf_to_reference, band_chol_from_reference,
                      band_chol_to_reference, phase_from_reference,
                      phase_to_reference)
from . import lapack_api
from . import cache, obs, robust, serve
from .utils.generator import generate_matrix, random_matrix, random_spd
from .utils.printing import print_matrix
