"""Serving: the micro-batcher (batcher.py) and the web app (webapp.py).

Import the web app from ``serving.webapp``: it pulls in the LLM layer,
which the batcher does not need.
"""
