"""The simulated KevlarFlow system: the cluster state machine, decoupled
communicator init, failure injection and detection, ring KV replication,
the load balancer and the recovery orchestrator, wired together by
``system.ServingSystem`` over a discrete sim clock and metadata KV pools."""
