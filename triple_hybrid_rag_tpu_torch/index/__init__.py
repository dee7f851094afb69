"""Index state and query-side index helpers."""
