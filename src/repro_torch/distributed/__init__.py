"""Host-side pieces of the distributed stack: gradient compression
(``collectives``) and fault tolerance (``fault_tolerance``).  The mesh,
sharding and the collectives themselves are not ported yet (ROADMAP.md,
queue 1 item 5)."""
