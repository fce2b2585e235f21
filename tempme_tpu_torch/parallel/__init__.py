"""Data-parallel TGN training over ``torch.distributed``: the mesh, the
process group and the edge-partitioned input pipeline, the sharded train
step, mesh checkpoints and the dry run (port of ``tempme_tpu/parallel/``).
"""
