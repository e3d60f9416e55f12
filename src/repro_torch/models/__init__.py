"""The LM stack's models (port of `repro/models/`): the dense transformer
(`layers`, `transformer`) and the token samplers (`sampling`)."""
