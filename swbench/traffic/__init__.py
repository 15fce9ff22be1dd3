"""Traffic generators, one module per kind, found by the kind's name.

A generator module has ``requests(params, config, db, seed)``, an endless
iterator of requests, each ``(queries, records)``: the encoded queries,
and the ids of the database records they were copied from, whose scores
the check compares besides its sample (empty where none were). It also
has ``warmup(params)``, the query lengths of each distinct request the
traffic sends, and ``submit(pipeline, queries, db, scoring)``, which makes
the program's call for one request and returns ``((queries, records)
scores, kernel seconds)``.
"""
