"""Parallelism over `torch.distributed` (mirror of `omnitokenizer_tpu.parallel`):
process groups, placement and collectives (`mesh`), the GPT's Megatron
tensor parallelism (`tp`), its GPipe pipeline (`pp`) and a multi-process
dry run of the GAN step (`dryrun`). Import the submodules directly."""
