"""The multi-shard package: hash-routed sharded counting (``sharded``), the
mesh-wide server (``serve``), the multi-process runtime (``distributed``)
and its collectives (``comm``)."""
