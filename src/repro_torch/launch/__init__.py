"""Command-line launchers — training (``train``) and real serving
(``serve``) — and the dry-run tools: the production meshes (``mesh``), the
inputs' stand-ins (``specs``), the per-op cost counter (``op_cost``), the
dry run itself (``dryrun``) and the hillclimb over its knobs
(``hillclimb``)."""
