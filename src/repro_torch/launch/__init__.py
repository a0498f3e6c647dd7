"""Launch entry points of the port (port of ``src/repro/launch/``)."""
