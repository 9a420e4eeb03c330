"""Drivers: one module per kind of load a traffic mix can name
(`"driver"` in its file). Each has `run(ctx) -> Outcome`."""
