"""Host-side numpy modules of the port (utils)."""
