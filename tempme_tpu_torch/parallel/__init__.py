"""Data-parallel training over ``torch.distributed``: the mesh, the process
group and the edge-partitioned input pipeline, the sharded TGN, explainer
and enhance train steps, mesh checkpoints and the dry run (port of
``tempme_tpu/parallel/``).
"""
