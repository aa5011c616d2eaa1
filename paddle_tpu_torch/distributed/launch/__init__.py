"""The launcher's elastic membership registry (counterpart of
paddle_tpu/distributed/launch's `elastic` module), which the serving fleet
joins. The launcher itself (`launch`, `main`) is not ported yet (ROADMAP
Queue A 13)."""
