"""Model workloads of the port (D3STN serving)."""
