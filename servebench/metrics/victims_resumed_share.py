"""Share of an instance kill's in-flight victims that resumed on the ring
peer from replicated KV (the rest restarted), from the engine's
``failure_events``; None without a kill that had victims."""


def compute(record):
    victims = sum(e["n_victims"] for e in record.failure_events
                  if e["granularity"] == "instance")
    if not victims:
        return None
    resumed = sum(e["resumed"] for e in record.failure_events
                  if e["granularity"] == "instance")
    return resumed / victims
