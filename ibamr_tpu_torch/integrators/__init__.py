"""Port of ibamr_tpu.integrators (see the package docstring)."""

# The integrator families import lazily (keep `import ibamr_tpu_torch`
# light); the module paths are the stable API:
#   ibamr_tpu_torch.integrators.ins            - staggered INS
#   ibamr_tpu_torch.integrators.ins_walls      - no-slip/moving-lid INS
#   ibamr_tpu_torch.integrators.ins_open       - inflow/outflow INS
#   ibamr_tpu_torch.integrators.ins_vc         - two-phase VC INS, both forms
#   ibamr_tpu_torch.integrators.ins_collocated - cell-centered INS
#   ibamr_tpu_torch.integrators.ib             - explicit marker IB
#   ibamr_tpu_torch.integrators.ib_open        - IB in an open channel
#   ibamr_tpu_torch.integrators.ib_implicit    - Newton-Krylov implicit IB
#   ibamr_tpu_torch.integrators.ibfe           - finite-element IB
#   ibamr_tpu_torch.integrators.cib            - constrained rigid bodies
#   ibamr_tpu_torch.integrators.constraint_ib  - prescribed kinematics
#   ibamr_tpu_torch.integrators.imp            - material points
#   ibamr_tpu_torch.integrators.adv_diff       - transported quantities
#   ibamr_tpu_torch.integrators.gib            - generalized IB / rods
#   ibamr_tpu_torch.integrators.penalty_ib     - penalty IB
