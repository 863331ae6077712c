"""Device models: sources and Level-1 MOSFET."""
