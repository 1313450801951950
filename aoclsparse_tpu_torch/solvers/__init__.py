"""Iterative solvers and smoothers: the CG/GMRES Krylov layer (the itsol
RCI and forward interfaces, the fused loops) and the ILU0, SymGS and SOR
preconditioners."""

from .fused import make_cg_operator, make_gmres_operator, pcg_solve, pgmres_solve  # noqa: F401
from .ilu import IluState, ilu0_factorize, ilu_smoother  # noqa: F401
from .itsol import (  # noqa: F401
    CgRci,
    GmresRci,
    ItsolHandle,
    RciJob,
    RINFO_ITER,
    RINFO_RES_NORM,
    RINFO_RHS_NORM,
    itsol_handle_prn_options,
    itsol_init,
    itsol_option_set,
    itsol_rci_input,
    itsol_rci_solve,
    itsol_solve,
    itsol_solve_operator,
)
from .options import OptionRegistry  # noqa: F401
from .sorv import sorv  # noqa: F401
from .symgs import symgs, symgs_mv  # noqa: F401
