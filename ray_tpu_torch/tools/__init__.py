"""Developer tooling of the port: the postmortem and tracing CLIs
(flightrec, tracebus, kvscope, incidents) and the perf ledger.
Nothing here runs on the hot path."""
