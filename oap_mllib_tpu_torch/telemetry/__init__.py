"""Telemetry of the port (the JAX package's ``telemetry``): the span tree
under every fit's timings (``spans``), the process's metrics registry
(``metrics``), the JSON-lines sink, reports and the fit boundary
(``export``), the flight recorder (``flightrec``) and the fleet
rollups with the live ``/metrics`` and ``/healthz`` endpoint
(``fleet``)::

    from oap_mllib_tpu_torch import telemetry

    model = KMeans(k=8).fit(x)
    print(telemetry.report(model.summary))     # the fit's span tree
    print(telemetry.render_prometheus())       # the registry as text
    model.summary.telemetry["spans"]           # the raw tree

The names below resolve on first use, so importing a submodule never
pulls in the others.
"""

_EXPORTS = {
    "Span": "spans", "current_span": "spans", "enter": "spans",
    "emit_fit": "export", "finalize_fit": "export", "report": "export", "sink_path": "export",
    "render_prometheus": "metrics", "snapshot": "metrics",
}


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    if name in ("fleet", "flightrec", "metrics", "export", "spans"):
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(name)
