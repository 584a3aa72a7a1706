"""Device-parallel layer: multi-start fleets, the job executor, and the
multi-GPU engines on torch.distributed (meshes, the pair-sharded and the
site-sharded MPS engines, the sharded statevector)."""

from .executor import run_jobs
from .mesh import make_mesh, num_local_qubits, shard_batch, shard_state
from .multistart import MultistartResult, multistart_minimize, random_initial_thetas
