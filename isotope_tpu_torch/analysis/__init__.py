"""Plan-time analysis of the port (the cost model's fleet chunking)."""
