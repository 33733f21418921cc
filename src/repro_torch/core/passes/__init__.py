from .vectorize import vectorize
from .bufferize import bufferize
from .queue_align import queue_align
from .model_specific import apply_store_streams
from .fuse import (FusedGroup, fuse_program, fuse_inputs, fuse_index_inputs,
                   group_roff, partition_members, split_outputs, stack_tables,
                   fusion_key)

__all__ = ["vectorize", "bufferize", "queue_align", "apply_store_streams",
           "FusedGroup", "fuse_program", "fuse_inputs", "fuse_index_inputs",
           "group_roff", "partition_members", "split_outputs", "stack_tables",
           "fusion_key"]
