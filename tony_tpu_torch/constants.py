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
CLUSTER_EPOCH = "TONY_CLUSTER_EPOCH"

# a cross-slice pipeline stage (tony.pipeline.stages): this gang's stage
# identity and its neighbours' channel hubs, as the executor exports
# them from the coordinator's channel registry
PIPELINE_STAGE = "TONY_PIPELINE_STAGE"
PIPELINE_NUM_STAGES = "TONY_PIPELINE_NUM_STAGES"
PIPELINE_RANK = "TONY_PIPELINE_RANK"
CHANNEL_PORT = "TONY_CHANNEL_PORT"
CHANNEL_PREV = "TONY_CHANNEL_PREV"
CHANNEL_NEXT = "TONY_CHANNEL_NEXT"
PIPELINE_INTERLEAVE = "TONY_PIPELINE_INTERLEAVE"
CHANNEL_COMPRESSION = "TONY_CHANNEL_COMPRESSION"

# observability (tony.task.profile.* and the goodput bridge): the port
# the executor reserved for the TensorBoard / live-capture listener,
# whether profiling is on and where traces go, and the file the
# process's goodput ledger publishes its cumulative snapshot to (the
# executor merges it into the ledger it ships on heartbeats)
TB_PORT = "TB_PORT"
TONY_PROFILE_ENABLED = "TONY_PROFILE_ENABLED"
TONY_PROFILE_DIR = "TONY_PROFILE_DIR"
TONY_GOODPUT_SPOOL = "TONY_GOODPUT_SPOOL"
