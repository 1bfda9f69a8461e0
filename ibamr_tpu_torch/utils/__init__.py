"""Run-loop utilities of the port: input files, metrics, timers,
checkpoints, the hierarchy driver and its resilience layer (health
probe, flight recorder, watchdog, supervisor, fleet lanes)."""

from ibamr_tpu_torch.utils.input_db import (InputDatabase, parse_input_file,
                                            parse_input_string)
from ibamr_tpu_torch.utils.gridfunctions import CartGridFunction
from ibamr_tpu_torch.utils.timers import TimerManager, timer
from ibamr_tpu_torch.utils.metrics import MetricsLogger
from ibamr_tpu_torch.utils.health import HealthDegraded, HealthProbe
from ibamr_tpu_torch.utils.flight_recorder import (FlightRecorder,
                                                   factory_spec)
from ibamr_tpu_torch.utils.watchdog import (RunWatchdog, heartbeat_age,
                                            read_heartbeat)

__all__ = [
    "InputDatabase",
    "parse_input_file",
    "parse_input_string",
    "CartGridFunction",
    "TimerManager",
    "timer",
    "MetricsLogger",
    "HealthDegraded",
    "HealthProbe",
    "FlightRecorder",
    "factory_spec",
    "RunWatchdog",
    "heartbeat_age",
    "read_heartbeat",
]
