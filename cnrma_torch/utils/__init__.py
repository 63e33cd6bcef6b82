"""PLY IO and mesh extraction of the port."""
