"""Serving entry points of the port: the HTTP API and the headless demo."""
