"""The general generators, one a traffic ``kind``. A generator's ``Cell``
takes (config, traffic, seed, device, vocab) and offers ``setup(parts)``,
``window(seconds)`` (its end-to-end metrics), ``traced_calls()``,
``attempted()``, ``failed()``, ``counts()`` (the work of the traced
window, for the per-layer metrics), ``free_program()``, ``numbers()`` (the
numbers compared with the reference) and ``control_numbers()`` (the
control's and the planted faults', for the calibration)."""
