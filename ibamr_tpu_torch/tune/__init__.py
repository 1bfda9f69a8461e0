"""Measured-search autotuner of the transfer engine (port of
``ibamr_tpu/tune/``).

No static engine choice is right across the size range, so the engine is
chosen by measurement:

- :mod:`ibamr_tpu_torch.tune.space`: candidate enumeration with static
  pruning (tile divisibility, minimum extents, the packed3 z tile, the
  wall-BC bf16 refusal) and a probe of the kernel engines on the device;
- :mod:`ibamr_tpu_torch.tune.runner`: measured trials (a warm-up chunk,
  then warm chunks timed between synchronizations) on the telemetry bus;
- :mod:`ibamr_tpu_torch.tune.db`: the versioned, provenance-stamped
  ``TUNING_DB.json`` that :mod:`ibamr_tpu_torch.models.engine_resolver`
  consults (schema v1 validation, the shadowed-entry lint, atomic
  publication).

``python -m ibamr_tpu_torch.tools.tune`` is the command line (search,
show, publish, check).
"""

from ibamr_tpu_torch.tune.db import (load_db, make_entry, make_provenance,
                                     merge_entry, save_db, shadowed_entries,
                                     validate_db)
from ibamr_tpu_torch.tune.space import Candidate, enumerate_space
from ibamr_tpu_torch.tune.runner import TrialResult, run_trial, search

__all__ = [
    "Candidate", "TrialResult", "enumerate_space", "load_db",
    "make_entry", "make_provenance", "merge_entry", "run_trial",
    "save_db", "search", "shadowed_entries", "validate_db",
]
