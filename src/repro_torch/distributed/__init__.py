"""Sharded serving over a mesh (port of ``repro/distributed``): the
logical-axis sharding rules (``sharding``), the scoped activation sharder
(``act_sharding``) and how a meshed step runs on each rank's rows
(``local``).  Importing this package touches no process group."""
