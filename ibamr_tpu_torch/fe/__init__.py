"""Finite-element structure layer for IBFE (port of ``ibamr_tpu/fe``)."""

from ibamr_tpu_torch.fe.fem import (FEAssembly, build_assembly,
                                    deformation_gradients, elastic_energy,
                                    l2_project_from_quads, neo_hookean,
                                    nodal_forces, nodal_forces_pk1, pk1,
                                    project_to_quads, quad_positions, stvk)
from ibamr_tpu_torch.fe.mesh import (FEMesh, block_mesh_tet, block_mesh_tri,
                                     box_hex_mesh, disc_mesh, read_triangle,
                                     rect_quad_mesh, to_quadratic)

__all__ = [
    "FEAssembly", "FEMesh", "block_mesh_tet", "block_mesh_tri",
    "box_hex_mesh", "build_assembly", "deformation_gradients",
    "disc_mesh", "elastic_energy", "l2_project_from_quads",
    "neo_hookean", "nodal_forces", "nodal_forces_pk1", "pk1",
    "project_to_quads", "quad_positions", "read_triangle",
    "rect_quad_mesh", "stvk", "to_quadratic",
]
