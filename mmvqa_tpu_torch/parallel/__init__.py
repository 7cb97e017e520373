"""The multi-GPU layouts: data parallelism, FSDP and tensor parallelism on
plain tensors, one process per rank (counterpart of mmvqa_tpu/parallel/)."""
