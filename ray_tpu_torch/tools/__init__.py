"""Developer tooling of the port (the postmortem CLI).  Nothing here
runs on the hot path."""
