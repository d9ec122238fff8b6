"""The distributed stack: the collectives over a mesh axis and gradient
compression (``collectives``) and fault tolerance (``fault_tolerance``);
the meshes are ``repro_torch.launch.mesh``.  Still to port (ROADMAP.md,
queue 1 item 5): ``sharding.py`` (the expert-parallel MoE) and the
data-parallel gradient all-reduce."""
