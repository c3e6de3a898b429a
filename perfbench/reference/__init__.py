"""The benchmark's plain reference path tracer: plain torch, importing
nothing of the program it judges and nothing of JAX."""
