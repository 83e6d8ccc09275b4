"""The benchmark's harness."""
