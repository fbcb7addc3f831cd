"""The names of the environment variables the port reads.

The port's own copy of the part of ``tony_tpu/constants.py`` a training
process needs: the task identity every executor exports, the bootstrap of
its two arms, and the mesh layout. The port imports nothing from
``tony_tpu``, so the strings are copied, not re-exported; the parity
tests hold the two tables equal.

The executor exports one of two bootstraps, by the job's framework:

- the jax arm (the default): :data:`JAX_COORDINATOR_ADDRESS` (``host:port``
  of process 0), :data:`JAX_PROCESS_ID`, :data:`JAX_NUM_PROCESSES` and
  :data:`MESH_SPEC` (``{"axes": {...}, "dcn_axes": {...}}``);
- the pytorch arm: :data:`INIT_METHOD` (``tcp://`` of the first worker),
  :data:`RANK` and :data:`WORLD`, and no mesh spec.
"""

# task identity (every framework)
JOB_NAME = "JOB_NAME"
TASK_INDEX = "TASK_INDEX"
TASK_NUM = "TASK_NUM"
SESSION_ID = "SESSION_ID"
ATTEMPT_NUMBER = "ATTEMPT_NUMBER"
CLUSTER_SPEC = "CLUSTER_SPEC"

# the pytorch arm
RANK = "RANK"
WORLD = "WORLD"
INIT_METHOD = "INIT_METHOD"

# the jax arm
JAX_COORDINATOR_ADDRESS = "TONY_JAX_COORDINATOR_ADDRESS"
JAX_PROCESS_ID = "TONY_JAX_PROCESS_ID"
JAX_NUM_PROCESSES = "TONY_JAX_NUM_PROCESSES"
MESH_SPEC = "TONY_MESH_SPEC"
SLICE_ID = "TONY_SLICE_ID"
NUM_SLICES = "TONY_NUM_SLICES"
