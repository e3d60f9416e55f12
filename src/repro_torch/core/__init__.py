"""Samplers, Bayes-net Gibbs engine and the numpy model front end."""
