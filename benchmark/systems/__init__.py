"""See benchmark/README.md."""
