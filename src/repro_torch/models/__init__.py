"""Model code of the port: shared layers, dense-family params, and the paged
decode path the serving engine runs."""
