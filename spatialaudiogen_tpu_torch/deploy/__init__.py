"""Deployment: full-video sliding-window inference."""
