"""Predictive preheat plane (counterpart of the reference's ``preheat/``):
demand forecasting drives seed placement.

- ``demand``: fold download records (and registry layer pulls) into
  bounded per-task demand time series,
- ``forecast``: the GRU next-horizon demand forecaster over those series,
  on the card,
- ``planner``: rank forecast-hot tasks against what seed peers already
  hold, pick RTT-central seeds, and submit budget-capped ``preheat`` jobs.

Like ``scheduler/``, this ``__init__`` stays import-light.
"""
