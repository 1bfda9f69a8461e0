"""Run-loop utilities of the port: input files, metrics, timers,
checkpoints and the hierarchy driver."""
