"""Job modules: the system under test. A mix names one (``"job"``); each
module defines ``Job(cfg, mix, seed, device, span)`` with ``warm()``,
``run(k) -> (key, answer)``, ``close()`` and ``prepare_s``, and
``check``, the reference's comparison for its answers."""
