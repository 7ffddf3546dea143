"""Distribution for the port (counterpart of ``repro.dist``): the logical
axis rules, the serving mesh and the (data, model) training mesh
(``dist.api``), elastic mesh planning (``dist.elastic``), the collectives
of tensor-parallel serving and sharded training, the compressed N:M ring
among them (``dist.collectives``), and the library's expert-parallel
all-to-all (``dist.moe_a2a``) and GPipe schedule (``dist.pipeline``)."""

from repro_torch.dist.api import (DEFAULT_RULES, MULTIPOD_RULES,
                                  SERVE_TP_RULES, ServeMesh, TrainMesh,
                                  axis_rules, current_mesh, current_rules,
                                  logical_to_pspec, make_serve_mesh,
                                  make_shardings, make_train_mesh,
                                  train_rules_for)

__all__ = ["DEFAULT_RULES", "MULTIPOD_RULES", "SERVE_TP_RULES", "ServeMesh",
           "TrainMesh", "axis_rules", "current_mesh", "current_rules",
           "logical_to_pspec", "make_serve_mesh", "make_shardings",
           "make_train_mesh", "train_rules_for"]
