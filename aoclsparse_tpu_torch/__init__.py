"""aoclsparse_tpu_torch — the PyTorch + CUDA port of aoclsparse_tpu.

Same public names and semantics as the JAX package for what is ported so
far: handles in every storage format (CSR, CSC, COO, BSR, TCSR, ELL, DIA)
with their conversions, export, copy and Matrix Market I/O (``io``), the
level-1 sparse-vector ops, hints and the planner, ``mv``/``dotmv``/
``mv_operator`` through the ``bandt``, ``bwd``, ``gen`` (general
structure), ``route``, ``diag``, ``sell``, gather and native-format forms
and the host engine, the format-direct ``csrmv``/``ellmv``/``elltmv``/
``ellthybmv``/``diamv``/``bsrmv``/``blkcsrmv``, ``mm`` through the
``bandtm``, ``diag``, ``bwdg`` and gather forms, ``trsv`` and ``trsm``
(blocked ``win``, ``dwin`` and ``gather`` forms, the level engine and the
host engine; f32, f64, bf16, complex64 and complex128 triangles, complex
ones on the level kernel or the blocked forms' plain loops; bf16 ``dwin``
and ``gather`` forms raise ``not_implemented`` on the card), ILU0, SymGS
and SOR, CG with no preconditioner (in
permuted space on a gen operand), ILU0 or SGS and restarted GMRES with
none (likewise) or ILU0 (``pcg_solve``, ``pgmres_solve``, the matrix-free
``make_cg_operator``/``make_gmres_operator``), the iterative-solver
framework (``itsol_*`` handles with the options registry, the RCI stepper
``itsol_rci_solve`` and ``RciJob``, the forward ``itsol_solve`` and
``itsol_solve_operator``), and the SpGEMM family (``sp2m``/``csr2m``/``spmm``
with the two-stage protocol and lazy band products, ``sp2md``, ``spmmd``,
``syrk``, ``syrkd``, ``sypr``, ``syprd``, ``add``). The band forms, the
group-window form, the diagonal form, the spill-route engine, the blocked
triangular solves and the SpGEMM band engine run hand-written CUDA kernels
on Hopper (csrc/band_spmv.cu, csrc/spmv_bwd.cu, csrc/spmm_band.cu,
csrc/spmm_diag.cu, csrc/spill_route.cu, csrc/benes.cu, csrc/trsv_win.cu,
csrc/trsv_blocked.cu, csrc/trsv_level.cu, csrc/band_gemm.cu), and so do the measurement path's tile-major and
block-window band SpMV and read probe (csrc/band_spmv_tiles.cu,
csrc/spmv_mxu.cu, csrc/stream_read.cu; utils/profiling.py times them),
built with nvcc at first use; on CPU tensors they run the kernels' plain
PyTorch versions. The host C++ library (native/) builds
with g++ at first use. Tensors go to ``cuda:0`` unless a device is named.
ROADMAP.md lists what is still to port (autotune, the plan cache,
checkpoints).
"""

from .core.types import (  # noqa: F401
    AoclSparseError,
    DiagType,
    FillMode,
    FormatType,
    IluType,
    IndexBase,
    MatrixSort,
    MatrixType,
    MemoryPolicy,
    Operation,
    Order,
    Request,
    SorType,
    Status,
)
from .core.descr import Doid, GENERAL, MatrixDescriptor, get_doid, trans_doid  # noqa: F401
from .core.formats import BSR, COO, CSC, CSR, DIA, ELL, SELL  # noqa: F401
from .core.matrix import (  # noqa: F401
    SparseMatrix,
    copy,
    create_bsr,
    create_coo,
    create_csc,
    create_csr,
    create_dia,
    create_ell,
    create_tcsr,
    destroy,
    export_coo,
    export_csc,
    export_csr,
    order_mat,
    set_value,
    update_values,
)
from .core.auxiliary import (  # noqa: F401
    convert_bsr,
    convert_csr,
    convert_format,
    debug_get,
    enable_instructions,
    is_tpu_build,
    set_precision_mode,
)
from .core.context import get_context  # noqa: F401
from .kernels.registry import debug_dispatcher  # noqa: F401
from .ops import (  # noqa: F401
    MvOperator,
    add,
    axpyi,
    blkcsrmv,
    bsrmv,
    csr2m,
    csrmv,
    csrsv,
    diamv,
    dotci,
    doti,
    dotmv,
    dotui,
    ellmv,
    ellthybmv,
    elltmv,
    gthr,
    gthrs,
    gthrz,
    mm,
    mv,
    mv_operator,
    roti,
    sctr,
    sctrs,
    sp2m,
    sp2md,
    spmm,
    spmmd,
    sypr,
    syprd,
    syrk,
    syrkd,
    trsm,
    trsv,
    trsv_strided,
)
from .convert.conversions import (  # noqa: F401
    csr2blkcsr,
    csr2bsr_nnz,
    csr2dia_ndiag,
    csr2ell_width,
    csr2ellthyb_width,
    opt_blksize,
)
from .planner import (  # noqa: F401
    optimize,
    set_2m_hint,
    set_dotmv_hint,
    set_lu_smoother_hint,
    set_memory_hint,
    set_mm_hint,
    set_mv_hint,
    set_mv_hint_kid,
    set_sm_hint,
    set_sorv_hint,
    set_sv_hint,
    set_symgs_hint,
)
from .solvers import (  # noqa: F401
    RciJob,
    ilu0_factorize,
    ilu_smoother,
    itsol_handle_prn_options,
    itsol_init,
    itsol_option_set,
    itsol_rci_input,
    itsol_rci_solve,
    itsol_solve,
    itsol_solve_operator,
    make_cg_operator,
    make_gmres_operator,
    pcg_solve,
    pgmres_solve,
    sorv,
    symgs,
    symgs_mv,
)

__version__ = "0.1.0"


def get_version() -> str:
    """aoclsparse_get_version analog."""
    return __version__
