"""Host-side runtime pieces of the port: flags, metrics, spans, RNG."""
