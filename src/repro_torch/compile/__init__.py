"""The compile chain of the port: model -> IR -> passes -> schedule ->
`CompiledProgram` (BN programs execute; MRF programs compile but their
execution is a later part of the port)."""
