"""Port of ibamr_tpu.models (see the package docstring)."""

from ibamr_tpu_torch.models.membrane2d import (build_membrane_example,
                                               make_circle_membrane)

__all__ = ["build_membrane_example", "make_circle_membrane"]
