"""Serving in the port: `engine.ServeEngine` (LM serving, slot-based
continuous batching over `models.model.decode_step`) and
`advisor_service.AdvisorFleetService` (the multi-tenant advisor fleet:
continuous batching over tenant `AdvisorSession`s, a shared SampleCF
prefetch and stacked cost phase per step, retries, quarantine and
durable recovery through `core.durability.DurableStore`)."""
