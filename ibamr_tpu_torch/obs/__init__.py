"""The process-wide telemetry bus (port of ``ibamr_tpu/obs/``).

Three primitives, one correlated stream per run:

- **spans**: nested wall-clock phases (:func:`span`), async-dispatch
  aware (``block_on=`` a pytree of tensors, the ``utils/timers.py``
  discipline) and mirrored into ``torch.profiler.record_function`` so
  phase names land in profiler traces;
- **counters / gauges / histograms**: a labeled metric registry every
  subsystem publishes into (checkpoint queue depth, supervisor retries,
  lane triage, replay verdicts, device-memory watermarks);
- **the run ledger**: a per-run append-only ``ledger.jsonl``
  (:class:`RunLedger`): spans close into it, counters snapshot into it
  at every chunk boundary, incidents and heartbeats cross-reference it
  by ``seq``, and every record carries the flight-recorder fingerprint
  digest as ``run_id``.

Telemetry reads no device value: all host-side work rides the run
loop's existing one-read-per-chunk sync points, and
``RunLedger.overhead_s`` accounts for the ledger's own cost.
:mod:`~ibamr_tpu_torch.obs.export` renders the registry in the
Prometheus text format and :mod:`~ibamr_tpu_torch.obs.merge` interleaves
per-process ledger shards. The read-back half is offline and imported on
demand: :mod:`~ibamr_tpu_torch.obs.deviceprof` attributes the device
time of a ``utils/timers.profile_trace`` capture to span paths (the
ledger's ``device_time`` record, ``prof_summary.json``), and
:mod:`~ibamr_tpu_torch.obs.roofline` joins that time with a call-level
FFT and contraction census into achieved rates.
"""

from ibamr_tpu_torch.obs.bus import (  # noqa: F401
    HISTOGRAM_BOUNDS,
    Histogram,
    LEDGER_SCHEMA,
    RunLedger,
    attach,
    chunk_boundary,
    counter,
    current,
    current_trace,
    describe,
    detach,
    emit,
    gauge,
    help_for,
    histogram,
    last_seq,
    ledger,
    metrics_snapshot,
    new_trace_id,
    peek_gauge,
    quantiles_from_counts,
    read_ledger,
    record_trace_ids,
    reset_metrics,
    run_id_from_fingerprint,
    sample_memory_watermarks,
    shard_path,
    span,
    trace_scope,
)
from ibamr_tpu_torch.obs.export import (  # noqa: F401
    prometheus_text,
    write_prometheus,
)
from ibamr_tpu_torch.obs.merge import (  # noqa: F401
    find_shards,
    fleet_counters,
    fleet_prometheus_text,
    merge_ledgers,
)
