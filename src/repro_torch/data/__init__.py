from repro_torch.data.pipeline import (SyntheticLMData, accum_for_mesh,
                                      batch_specs, local_batch, to_device)

__all__ = ["SyntheticLMData", "accum_for_mesh", "batch_specs", "local_batch",
           "to_device"]
