"""dpilqr_tpu: accelerator-native distributed potential iLQR in JAX.

A from-scratch JAX/XLA re-design of the capabilities of labicon/dp-ilqr:
cooperative multi-agent trajectory optimization as a potential game, solved
with iterative LQR and scaled by proximity-based problem decomposition --
expressed as batched block-structured array programs (lax.scan sweeps, a
Triton Riccati kernel, vmapped subproblem batches, sharded device meshes)
instead of the reference's object graphs, Cython kernel and
multiprocessing pool.
"""

from . import config  # noqa: F401  (enables x64; must import first)

from .config import DEFAULT_CONFIG, SolverConfig
from .models import (
    BIKE_5D,
    CAR_3D,
    DOUBLE_INT_4D,
    DOUBLE_INT_6D,
    GRAVITY,
    HUMAN_6D,
    HUMAN_LIN_6D,
    MODEL_BY_NAME,
    MODEL_REGISTRY,
    QUAD_6D,
    QUAD_12D,
    UNICYCLE_4D,
    Fleet,
    ModelSpec,
    get_model,
    homogeneous_fleet,
)
from .parallel import (
    DistributedResult,
    RhcResult,
    RhcStepInfo,
    graph_to_dict,
    interaction_graph,
    make_mesh,
    selfish_warmstart,
    solve_distributed,
    solve_distributed_sharded,
    solve_rhc,
    solve_trials_sharded,
)
from .utils import (
    Rate,
    compute_energy,
    distance_to_goal,
    face_goal,
    normalize_energy,
    pairwise_distances,
    perturb_state,
    random_setup,
    randomize_locs,
)
from .ops import (
    GameCost,
    SolveResult,
    ilqr_solve,
    make_game_cost,
    make_solver,
    proximity_cost,
    quadraticize_stage,
    quadraticize_terminal,
    rollout,
    stage_cost,
    terminal_cost,
)

__version__ = "0.1.0"
