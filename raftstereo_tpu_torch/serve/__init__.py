"""Serving: the batch engine and the HTTP server."""
