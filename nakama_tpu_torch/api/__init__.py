"""Front door of the port's server: the REST API and `/ws` over the
standard-library transport (`wsproto`), the realtime pipeline, session
tokens and the matched-event fan-out."""
