"""Command-line launchers of the port (serve, train, the hillclimb and
tuners, the dry run) with the meshes they run on and the backend
record (``backend``)."""
