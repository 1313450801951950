"""aoclsparse_tpu_torch — the PyTorch + CUDA port of aoclsparse_tpu.

Same public names and semantics as the JAX package for what is ported so
far: CSR handles, hints and the planner, ``mv``/``dotmv``/``mv_operator``
through the ``bandt``, ``gen`` (general structure), ``route`` and gather
execution forms, ``mm`` through the ``bandtm``, ``diag``, ``bwdg`` and
gather forms, blocked ``trsv`` and ``trsm``, ILU0 and CG with no
preconditioner (in permuted space on a gen operand), ILU0 or SGS. The band
forms, the diagonal form, the spill-route engine and the blocked triangular
solves run hand-written CUDA kernels on Hopper (csrc/band_spmv.cu,
csrc/spmm_band.cu, csrc/spmm_diag.cu, csrc/spill_route.cu, csrc/benes.cu,
csrc/trsv_win.cu), built with nvcc at first use; on CPU tensors they run
the kernels' plain PyTorch versions. The host C++
factorization (native/) builds with g++ at first use. Tensors go to
``cuda:0`` unless a device is named. ROADMAP.md lists what is still to
port.
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
from .core.formats import CSR  # noqa: F401
from .core.matrix import (  # noqa: F401
    SparseMatrix,
    create_csr,
    destroy,
    export_csr,
    update_values,
)
from .core.auxiliary import set_precision_mode  # noqa: F401
from .core.context import get_context  # noqa: F401
from .kernels.registry import debug_dispatcher  # noqa: F401
from .ops import MvOperator, csrsv, dotmv, mm, mv, mv_operator, trsm, trsv, trsv_strided  # noqa: F401
from .planner import (  # noqa: F401
    optimize,
    set_lu_smoother_hint,
    set_memory_hint,
    set_mm_hint,
    set_mv_hint,
    set_sm_hint,
    set_sv_hint,
)
from .solvers import ilu_smoother, pcg_solve  # noqa: F401

__version__ = "0.1.0"


def get_version() -> str:
    """aoclsparse_get_version analog."""
    return __version__
