"""The UmeTrack network: config, layers, trunk, fusion, memory, heads."""
