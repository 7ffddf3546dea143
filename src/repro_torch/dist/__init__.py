"""Distribution for the port (counterpart of ``repro.dist``): the logical
axis rules and the serving mesh (``dist.api``), and the collectives of
tensor-parallel serving, the compressed N:M ring among them
(``dist.collectives``)."""

from repro_torch.dist.api import (DEFAULT_RULES, MULTIPOD_RULES,
                                  SERVE_TP_RULES, ServeMesh, axis_rules,
                                  current_mesh, current_rules,
                                  logical_to_pspec, make_serve_mesh,
                                  make_shardings)

__all__ = ["DEFAULT_RULES", "MULTIPOD_RULES", "SERVE_TP_RULES", "ServeMesh",
           "axis_rules", "current_mesh", "current_rules", "logical_to_pspec",
           "make_serve_mesh", "make_shardings"]
