"""Example drivers of the port (counterparts of ``examples/``)."""
