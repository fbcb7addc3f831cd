"""The serving keys, copied from ``tony_tpu/conf/keys.py`` (the port
imports nothing of ``tony_tpu``; the parity tests hold the strings and
defaults equal).

Per-class decode-slot floors, the queue depth past which standard/batch
submissions are shed with BUSY (0 = unbounded), the BUSY frame's retry
hint, and the latency histograms' bucket bounds (empty = the built-in
ladder). The router's health ping: its cadence, and the consecutive
UNANSWERED pings after which a connected-but-hung replica is marked
down. :data:`SERVE_DEFAULTS` and :data:`ROUTER_DEFAULTS` hold the JAX
package's defaults.
"""

SERVE_SLOTS_INTERACTIVE_KEY = "tony.serve.slots.interactive"
SERVE_SLOTS_STANDARD_KEY = "tony.serve.slots.standard"
SERVE_SLOTS_BATCH_KEY = "tony.serve.slots.batch"
SERVE_MAX_QUEUE_DEPTH_KEY = "tony.serve.max-queue-depth"
SERVE_BUSY_RETRY_MS_KEY = "tony.serve.busy-retry-ms"
METRICS_LATENCY_BUCKETS_KEY = "tony.metrics.latency-buckets"

SERVE_DEFAULTS = {
    SERVE_SLOTS_INTERACTIVE_KEY: "0",
    SERVE_SLOTS_STANDARD_KEY: "0",
    SERVE_SLOTS_BATCH_KEY: "0",
    SERVE_MAX_QUEUE_DEPTH_KEY: "128",
    SERVE_BUSY_RETRY_MS_KEY: "250",
    METRICS_LATENCY_BUCKETS_KEY: "",
}

ROUTER_HEALTH_INTERVAL_MS_KEY = "tony.router.health-interval-ms"
ROUTER_MAX_MISSED_PINGS_KEY = "tony.router.max-missed-pings"

ROUTER_DEFAULTS = {
    ROUTER_HEALTH_INTERVAL_MS_KEY: "500",
    ROUTER_MAX_MISSED_PINGS_KEY: "3",
}
