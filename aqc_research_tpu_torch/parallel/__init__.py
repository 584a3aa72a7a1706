"""Multi-start execution: lane-batched fleets and the job executor."""

from .executor import run_jobs
from .multistart import MultistartResult, multistart_minimize, random_initial_thetas
