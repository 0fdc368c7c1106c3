"""Generative serving on one CUDA card: engine, predictor, HTTP server."""
