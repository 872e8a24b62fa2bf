"""APDFQ run_pipeline and CLI for the port."""
