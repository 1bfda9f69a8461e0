"""Fault-tolerant ensemble data assimilation (port of
``ibamr_tpu/assim/``).

The lane fleet as a statistical object: a masked EnKF/ESRF analysis
(:mod:`~ibamr_tpu_torch.assim.enkf`) updates all B lanes between driver
chunks from instrument-panel observations
(:mod:`~ibamr_tpu_torch.assim.observe`), behind a per-channel QC gate
(:mod:`~ibamr_tpu_torch.assim.qc`), orchestrated by the supervised
:class:`~ibamr_tpu_torch.assim.cycle.AssimilationCycle`.
"""

from ibamr_tpu_torch.assim.cycle import (INFLATION_FALLBACKS, AssimConfig,
                                         AssimilationCycle, FilterDegraded)
from ibamr_tpu_torch.assim.enkf import (AnalysisDiag, esrf_analysis,
                                        masked_moments, masked_spread,
                                        state_packer)
from ibamr_tpu_torch.assim.observe import (ObservationBatch,
                                           ObservationOperator,
                                           stream_from_list,
                                           synthesize_batches)
from ibamr_tpu_torch.assim.qc import QCConfig, screen

__all__ = [
    "AnalysisDiag", "AssimConfig", "AssimilationCycle",
    "FilterDegraded", "INFLATION_FALLBACKS", "ObservationBatch",
    "ObservationOperator", "QCConfig", "esrf_analysis",
    "masked_moments", "masked_spread", "screen", "state_packer",
    "stream_from_list", "synthesize_batches",
]
