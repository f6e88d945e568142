"""Data parallelism over envs for the port: parallel/mesh.py, parallel/worker.py."""
