"""Run logging and profiler tracing of the port."""
