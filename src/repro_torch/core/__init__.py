"""Event words, routing tables, aggregation cost model and credit banks."""
