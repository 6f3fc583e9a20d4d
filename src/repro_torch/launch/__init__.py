"""Command-line launchers: training (``train``) and real serving
(``serve``)."""
