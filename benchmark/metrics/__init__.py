"""The per-layer metrics: one reader a metric, ``<metric name>.py`` with
``read(ctx)``, found by name, and what the readers measure with: the card's
published peaks (``peaks``), the work an evaluation needs (``work``), pair
counting (``pairs``) and the shared arithmetic (``readers``). Later changes
to the program cannot move any of it."""
