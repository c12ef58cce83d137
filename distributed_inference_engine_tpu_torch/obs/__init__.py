"""The worker's telemetry (copies of the JAX package's ``obs/`` modules
the worker, engine and pump fill): the typed event ring
(``events.EventLog``), the engine's step timeline
(``timeline.StepTimeline``), the metrics registry with its OpenMetrics
exposition (``registry.MetricsRegistry``) and the collector tables that
map the worker's and the engines' metric dicts into families
(``collectors``). Names, dict keys and the text format are the JAX
package's, so a JAX coordinator or scraper reads a port worker unchanged.
Nothing here imports torch.
"""

from .events import EVENTS, EventLog  # noqa: F401
from .registry import OPENMETRICS_CONTENT_TYPE, MetricsRegistry  # noqa: F401
from .timeline import StepTimeline  # noqa: F401
