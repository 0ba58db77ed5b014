"""Data-parallel sharded training on ``torch.distributed``.

``sharding`` holds the reference's name-based rules (``param_pspec``,
``batch_pspec``, ``cache_pspec``) and maps their specs onto DTensor
placements; ``ctx`` is the activation-constraint context; ``comm`` is the
one module through which a rank talks to the others; ``train_step`` is the
sharded step built from them.
"""
