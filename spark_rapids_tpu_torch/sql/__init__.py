"""The SQL frontend: the JAX package's lexer, AST and parser (host-only
copies) and its planner onto the port's DataFrame API
(``TpuSession.sql``)."""
