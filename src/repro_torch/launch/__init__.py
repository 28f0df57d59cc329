"""Launchers: the paged serving engine and its CLI."""
