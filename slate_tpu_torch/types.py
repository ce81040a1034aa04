"""Enums and options (reference include/slate/enums.hh, types.hh).

The per-call ``opts`` dict is the analog of SLATE's
``Options = std::map<Option, OptionValue>`` (types.hh:61). The keys are
kept whole so that option-compatible call sites keep working; the port
reads ``Option.TrailingPrecision``, ``Option.MethodLU``,
``Option.MethodGels``, ``Option.MethodEig``, ``Option.MethodSVD``,
``Option.EigBand``, ``Option.MethodGemm`` and, on a p×q grid,
``Option.ChunkSize`` and ``Option.Lookahead`` (:func:`superstep_chunk`).
``Option.PipelineDepth`` is accepted and changes nothing: the port has
one schedule, whose ranks share one stream, so a lookahead would only
reorder the same work.
"""

from __future__ import annotations

import enum
from typing import Any, Mapping


class Op(enum.Enum):
    """Transposition flag (BLAS op; reference blaspp Op)."""
    NoTrans = "n"
    Trans = "t"
    ConjTrans = "c"


class Uplo(enum.Enum):
    Lower = "l"
    Upper = "u"
    General = "g"


class Diag(enum.Enum):
    NonUnit = "n"
    Unit = "u"


class Side(enum.Enum):
    Left = "l"
    Right = "r"


class Norm(enum.Enum):
    """Matrix norm kind (reference lapackpp Norm; src/norm.cc)."""
    One = "1"
    Two = "2"
    Inf = "i"
    Fro = "f"
    Max = "m"


class NormScope(enum.Enum):
    """Norm over the whole matrix or per column (reference
    enums.hh NormScope)."""
    Matrix = "m"
    Columns = "c"
    Rows = "r"


class GridOrder(enum.Enum):
    """Process-grid rank ordering (reference enums.hh:127-131): rank r
    sits at grid coordinate (r % p, r // p) for Col, (r // q, r % q) for
    Row."""
    Col = "c"
    Row = "r"


class Option(enum.Enum):
    """Option keys (reference enums.hh:69-101)."""
    ChunkSize = enum.auto()
    Lookahead = enum.auto()
    BlockSize = enum.auto()
    InnerBlocking = enum.auto()
    MaxPanelThreads = enum.auto()
    Tolerance = enum.auto()
    Target = enum.auto()
    TileReleaseStrategy = enum.auto()
    HoldLocalWorkspace = enum.auto()
    Depth = enum.auto()
    MaxIterations = enum.auto()
    UseFallbackSolver = enum.auto()
    PivotThreshold = enum.auto()
    PrintVerbose = enum.auto()
    PrintEdgeItems = enum.auto()
    PrintWidth = enum.auto()
    PrintPrecision = enum.auto()
    MethodCholQR = enum.auto()
    MethodEig = enum.auto()
    MethodGels = enum.auto()
    MethodGemm = enum.auto()
    MethodHemm = enum.auto()
    MethodLU = enum.auto()
    MethodTrsm = enum.auto()
    MethodSVD = enum.auto()
    EigBand = enum.auto()
    # precision tier for the O(n³) trailing updates
    # (internal/precision.py); panels and triangular solves always run
    # at full FP32 whatever this says
    TrailingPrecision = enum.auto()
    PipelineDepth = enum.auto()
    Abft = enum.auto()


Options = Mapping[Option, Any]


_DEFAULTS = {
    Option.Lookahead: 1,
    Option.BlockSize: 256,
    Option.InnerBlocking: 16,
    Option.MaxPanelThreads: 1,
    Option.Tolerance: None,
    Option.MaxIterations: 30,
    Option.UseFallbackSolver: True,
    Option.PivotThreshold: 1.0,
    Option.PrintVerbose: 4,
    Option.PrintEdgeItems: 16,
    Option.PrintWidth: 10,
    Option.PrintPrecision: 4,
    Option.TrailingPrecision: "bf16_6x",
    Option.PipelineDepth: 0,
    Option.Abft: False,
}


def get_option(opts: Options | None, key: Option, default: Any = None) -> Any:
    """Typed option getter (reference types.hh:166-200)."""
    if opts is not None and key in opts:
        return opts[key]
    if default is not None:
        return default
    return _DEFAULTS.get(key)


def superstep_chunk(kt: int, lcm_pq: int, opts: Options | None = None) -> int:
    """Block columns per super-step chunk of the p×q factorizations
    (potrf/getrf; ``slate_tpu/types.py:192-230``).

    ``Option.ChunkSize`` sets the chunk length directly, rounded up to a
    multiple of lcm(p, q) so that every chunk starts grid-aligned.
    Otherwise ``Option.Lookahead`` scales it: the default 1 splits the
    factorization into about 8 chunks, a higher lookahead into fewer,
    longer ones (reference ``Option::Lookahead``, src/potrf.cc:88-107).
    """
    def _cdiv(a, b):
        return -(-a // b)

    cs = get_option(opts, Option.ChunkSize)
    if cs:
        return max(lcm_pq, _cdiv(int(cs), lcm_pq) * lcm_pq)
    la = max(1, int(get_option(opts, Option.Lookahead)))
    n_chunks = max(1, 8 // la)
    return max(lcm_pq, _cdiv(_cdiv(kt, n_chunks), lcm_pq) * lcm_pq)


class MethodGemm(enum.Enum):
    """gemm variant on a p×q grid (reference method.hh:25-92): GemmC is
    the broadcast SUMMA, Ring the systolic Cannon ring, GemmA
    stationary-A with a reduce-scatter epilogue."""
    Auto = enum.auto()
    GemmA = enum.auto()
    GemmC = enum.auto()
    Ring = enum.auto()


class MethodLU(enum.Enum):
    Auto = enum.auto()
    PartialPiv = enum.auto()
    CALU = enum.auto()      # tournament pivoting (reference getrf_tntpiv.cc)
    NoPiv = enum.auto()

    @staticmethod
    def select_algo(A, opts=None) -> "MethodLU":
        """The LU method ``Option.MethodLU`` asks for (``Auto`` means
        partial pivoting)."""
        m = get_option(opts, Option.MethodLU, MethodLU.Auto)
        return MethodLU.PartialPiv if m == MethodLU.Auto else m


class MethodGels(enum.Enum):
    Auto = enum.auto()
    Geqrf = enum.auto()
    Cholqr = enum.auto()

    @staticmethod
    def select_algo(A, B, opts=None) -> "MethodGels":
        """The least-squares method ``Option.MethodGels`` asks for;
        ``Auto`` means CholQR for m ≥ 2n and Householder QR otherwise
        (reference gels.cc:96-110)."""
        m = get_option(opts, Option.MethodGels, MethodGels.Auto)
        if m != MethodGels.Auto:
            return m
        return MethodGels.Cholqr if A.m >= 2 * A.n else MethodGels.Geqrf


class MethodEig(enum.Enum):
    """Eigensolver method (reference enums.hh; ``slate_tpu/types.py``).
    QR and DC name the tridiagonal stage of the two-stage pipeline;
    Dense is ``torch.linalg.eigh`` on the whole matrix."""
    Auto = enum.auto()
    QR = enum.auto()
    DC = enum.auto()
    Bisection = enum.auto()
    MRRR = enum.auto()
    Dense = enum.auto()
    TwoStage = enum.auto()


class MethodSVD(enum.Enum):
    """SVD method: Dense is ``torch.linalg.svd`` on the whole matrix,
    TwoStage the ge2tb → tb2bd → bdsqr pipeline."""
    Auto = enum.auto()
    QRIteration = enum.auto()
    DC = enum.auto()
    Jacobi = enum.auto()
    Dense = enum.auto()
    TwoStage = enum.auto()
