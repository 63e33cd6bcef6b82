"""Data parallelism across processes: one scene a rank."""
