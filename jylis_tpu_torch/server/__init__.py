"""RESP codec and TCP server."""
