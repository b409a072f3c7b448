"""Host-side helpers of the verify spine: backoff, circuit breaker,
device fault injection, structured logging, lock construction and the
orderly exit of background threads; and the domain types' bit array."""
