"""Command-line launcher of the ASP time-evolution simulation:

    python -m aqc_research_tpu_torch.models.sp_lhs.run_time_evol -n 20 [-t] [-g tag] [-f targets_file] [--resume dir]

On the CUDA card by default, in the fast precision (float32/complex64),
with the optimization loop of models/sp_lhs/jit_asp.py on the card;
``--cpu`` runs on the CPU in the high precision (float64/complex128), where
``UserOptions.use_jit_lbfgs`` resolves to the host protocol (SciPy's
L-BFGS-B over the surrogate objectives), as the JAX launcher's ``--cpu``
does.  A script takes the host protocol on the card with
``opts.use_jit_lbfgs = False``.  The objective is ``UserOptions.objective``, as in the JAX launcher: the MPS
``"sur_fast_mps_trotter"`` by default, the dense ``"sur_max"`` where a
script sets it (``run_simulation(opts)`` from Python).
"""

from __future__ import annotations

from argparse import ArgumentParser

from ... import config
from ...utils import create_logger, script_entry_point
from .evol_utils import get_commandline_args
from .time_evol import run_simulation
from .user_options import UserOptions

_logger = create_logger(__file__)


def main() -> None:
    cargs = get_commandline_args(ArgumentParser(description=__doc__))
    opts = UserOptions(cargs)
    if cargs.cpu:
        config.set_device("cpu")
        config.set_precision("high")
    else:
        config.set_precision("fast")
    script_entry_point(lambda o: run_simulation(o), opts, _logger)


if __name__ == "__main__":
    main()
