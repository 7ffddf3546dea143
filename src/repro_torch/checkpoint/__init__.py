from repro_torch.checkpoint.manager import (CheckpointManager, gather_state,
                                           shard_state)

__all__ = ["CheckpointManager", "gather_state", "shard_state"]
