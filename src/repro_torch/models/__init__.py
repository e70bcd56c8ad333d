"""Models: config, layers, assembly and serving steps."""
