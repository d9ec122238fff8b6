"""The distributed stack: the collectives over a mesh axis, their
differentiable forms and gradient compression (``collectives``), the
sharding rules and their application on a rank (``sharding``) and fault
tolerance (``fault_tolerance``); the meshes are
``repro_torch.launch.mesh`` (a dry mesh plays one rank of a large one
in one process, its collectives reporting their bytes and calling
nothing).  The expert-parallel MoE is
``models/moe.py`` under a ``ShardingCtx``, the data-parallel gradient
all-reduce ``train/train_step.py``."""
