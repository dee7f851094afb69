"""Host-side models of the query path: planner, hash embedders, entity lookup."""
