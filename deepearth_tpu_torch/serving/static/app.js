/* DeepEarth-TPU dashboard frontend.
 *
 * Vanilla-JS single-page app over the JSON API — the TPU-native rebuild of
 * the reference's Leaflet/Three.js dashboard
 * (reference: dashboard/static/js/dashboard.js:1-3924 — observation map,
 * species explorer, vision feature viewer, embedding UMAP views,
 * ecosystem analysis; zero-egress canvas rendering here instead of CDN
 * map tiles / WebGL libs).
 */
"use strict";

// ---------------------------------------------------------------- state --
const S = {
  observations: [],          // [{gbif_id, lat, lon, species, year?}]
  speciesColors: {},         // species -> [r,g,b] 0..1
  speciesCounts: {},         // species -> count
  speciesNames: {},          // species -> display name (config, optional)
  visionIds: new Set(),      // gbif ids with vision embeddings
  ecoLabels: null,           // gbif_id -> cluster id (after analysis)
  map: { cx: 0, cy: 0, scale: 1, dragging: false, lastX: 0, lastY: 0 },
  emb: { data: null, yaw: 0.6, pitch: 0.4, dragging: false,
         lastX: 0, lastY: 0, dims: 2,
         // animated transitions between projections (reference:
         // dashboard.js animationParams — duration/easing)
         anim: { from: null, t0: 0, duration: 700 } },
  gallery: { built: false, shown: 0, pageSize: 24, observer: null },
  selectedSpecies: "",
  yearBounds: null,
};

const $ = (id) => document.getElementById(id);
async function api(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(`${path}: HTTP ${r.status}`);
  return r.json();
}
const fmt = (x, d = 4) => Number(x).toFixed(d);
const css = (rgb) =>
  `rgb(${Math.round(rgb[0] * 255)},${Math.round(rgb[1] * 255)},${Math.round(rgb[2] * 255)})`;
const speciesName = (s) => S.speciesNames[s] || `species ${s}`;
const speciesColor = (s) => S.speciesColors[s] || [0.6, 0.6, 0.6];

// ------------------------------------------------------------- colormaps --
// compact polynomial fits of matplotlib's plasma/viridis (t in [0,1])
const COLORMAPS = {
  plasma(t) {
    return [
      0.05 + 2.36 * t - 1.46 * t * t,
      Math.max(0, -0.11 + 0.57 * t + 0.53 * t * t),
      0.53 + 1.39 * t - 1.78 * t * t,
    ].map((v) => Math.min(1, Math.max(0, v)));
  },
  viridis(t) {
    return [
      0.28 - 0.56 * t + 1.24 * t * t,
      0.0 + 1.4 * t - 0.55 * t * t,
      0.33 + 1.2 * t - 1.4 * t * t,
    ].map((v) => Math.min(1, Math.max(0, v)));
  },
  gray: (t) => [t, t, t],
};
const CLUSTER_COLORS = [
  [0.31, 0.66, 0.44], [0.85, 0.55, 0.22], [0.36, 0.54, 0.85],
  [0.8, 0.36, 0.55], [0.64, 0.74, 0.3], [0.5, 0.42, 0.8],
  [0.3, 0.73, 0.72], [0.78, 0.68, 0.35], [0.72, 0.45, 0.33],
  [0.44, 0.62, 0.6], [0.62, 0.5, 0.55], [0.55, 0.67, 0.82],
  [0.75, 0.58, 0.7], [0.47, 0.56, 0.35], [0.66, 0.62, 0.52],
  [0.56, 0.48, 0.42],
];

// ------------------------------------------------------------------ tabs --
document.querySelectorAll(".tab").forEach((b) =>
  b.addEventListener("click", () => switchView(b.dataset.view))
);
function switchView(view) {
  document.querySelectorAll(".tab").forEach((b) =>
    b.classList.toggle("active", b.dataset.view === view));
  document.querySelectorAll(".view").forEach((v) =>
    v.classList.toggle("active", v.id === view));
  if (view === "map-view") drawMap();
  if (view === "gallery-view" && !S.gallery.built) buildGallery(true);
}

// ------------------------------------------------------------------ boot --
async function boot() {
  const [health, config, species, colors, obs, avail] = await Promise.all([
    api("/api/health"), api("/api/config"), api("/api/species"),
    api("/api/species_umap_colors"),
    api("/api/observations?limit=20000"),
    api("/api/vision_embeddings/available"),
  ]);
  S.speciesCounts = species.counts || {};
  for (const [k, v] of Object.entries(colors.colors || {}))
    S.speciesColors[k] = v;
  S.speciesNames = config.species_names || {};
  S.observations = obs.observations || [];
  S.visionIds = new Set(avail.ids || []);

  $("total-observations").textContent = health.n_observations;
  $("total-species").textContent = species.n_species;
  $("total-vision").textContent = avail.count;
  $("health-status").textContent = health.status;

  const years = S.observations.map((o) => o.year).filter((y) => y != null);
  if (years.length) {
    S.yearBounds = [Math.min(...years), Math.max(...years)];
    $("year-min").value = S.yearBounds[0];
    $("year-max").value = S.yearBounds[1];
  }
  for (const selId of ["species-filter", "gallery-species"]) {
    const sel = $(selId);
    for (const s of Object.keys(S.speciesCounts).sort((a, b) => a - b)) {
      const o = document.createElement("option");
      o.value = s;
      o.textContent = `${speciesName(s)} (${S.speciesCounts[s]})`;
      sel.appendChild(o);
    }
  }
  buildLegend();
  buildSpeciesTable();
  buildFeatureSelect();
  resetMapView();
  drawMap();
  pollProgress();
}

async function pollProgress() {
  try {
    const p = await api("/api/progress");
    const b = $("progress-banner");
    if (p.status && p.status !== "idle") {
      b.textContent = `training: ${Object.entries(p)
        .map(([k, v]) => `${k}=${typeof v === "number" ? fmt(v, 3) : v}`)
        .join("  ")}`;
      b.classList.remove("hidden");
    } else b.classList.add("hidden");
  } catch (e) { /* server gone — stop banner updates quietly */ }
  setTimeout(pollProgress, 4000);
}

// ------------------------------------------------------------------- map --
// world = (lon, lat); screen = canvas px. scale = px per degree.
function mapToScreen(lon, lat, c) {
  const m = S.map;
  return [
    c.width / 2 + (lon - m.cx) * m.scale,
    c.height / 2 - (lat - m.cy) * m.scale,
  ];
}
function screenToMap(x, y, c) {
  const m = S.map;
  return [m.cx + (x - c.width / 2) / m.scale, m.cy - (y - c.height / 2) / m.scale];
}
function resetMapView() {
  const c = $("map");
  if (!S.observations.length) return;
  const lats = S.observations.map((o) => o.lat);
  const lons = S.observations.map((o) => o.lon);
  const [lat0, lat1] = [Math.min(...lats), Math.max(...lats)];
  const [lon0, lon1] = [Math.min(...lons), Math.max(...lons)];
  S.map.cx = (lon0 + lon1) / 2;
  S.map.cy = (lat0 + lat1) / 2;
  S.map.scale = 0.9 * Math.min(
    c.width / Math.max(lon1 - lon0, 1e-6),
    c.height / Math.max(lat1 - lat0, 1e-6));
}

function filteredObservations() {
  const sp = S.selectedSpecies;
  const visOnly = $("show-vision-only").checked;
  const y0 = parseInt($("year-min").value), y1 = parseInt($("year-max").value);
  return S.observations.filter((o) => {
    if (sp !== "" && String(o.species) !== sp) return false;
    if (visOnly && !S.visionIds.has(o.gbif_id)) return false;
    if (o.year != null && !isNaN(y0) && (o.year < y0 || o.year > y1))
      return false;
    return true;
  });
}

let gridCache = null;
async function drawGridOverlay(ctx, c) {
  if (!gridCache) gridCache = await api("/api/grid_statistics?n_bins=12");
  const { grid, lat_edges, lon_edges } = gridCache;
  if (!grid.length) return;
  const maxC = Math.max(...grid.flat(), 1);
  for (let i = 0; i < grid.length; i++)
    for (let j = 0; j < grid[i].length; j++) {
      if (!grid[i][j]) continue;
      const [x0, y0] = mapToScreen(lon_edges[j], lat_edges[i + 1], c);
      const [x1, y1] = mapToScreen(lon_edges[j + 1], lat_edges[i], c);
      ctx.fillStyle = `rgba(78,168,111,${0.12 + 0.5 * (grid[i][j] / maxC)})`;
      ctx.fillRect(x0, y0, x1 - x0, y1 - y0);
      if (x1 - x0 > 34) {
        ctx.fillStyle = "rgba(216,222,230,.75)";
        ctx.font = "10px system-ui";
        ctx.fillText(grid[i][j], x0 + 3, y1 - 4);
      }
    }
}

async function drawMap() {
  const c = $("map");
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  if ($("show-grid").checked) await drawGridOverlay(ctx, c);
  const pts = filteredObservations();
  const byEco = $("color-by-ecosystem").checked && S.ecoLabels;
  for (const o of pts) {
    const [x, y] = mapToScreen(o.lon, o.lat, c);
    if (x < -4 || y < -4 || x > c.width + 4 || y > c.height + 4) continue;
    const col = byEco && S.ecoLabels[o.gbif_id] != null
      ? CLUSTER_COLORS[S.ecoLabels[o.gbif_id] % CLUSTER_COLORS.length]
      : speciesColor(o.species);
    ctx.fillStyle = css(col);
    ctx.beginPath();
    ctx.arc(x, y, S.visionIds.has(o.gbif_id) ? 4 : 2.6, 0, 6.3);
    ctx.fill();
    if (S.visionIds.has(o.gbif_id)) {
      ctx.strokeStyle = "rgba(255,255,255,.55)";
      ctx.stroke();
    }
  }
  $("map-status").textContent =
    `${pts.length} / ${S.observations.length} observations shown` +
    (byEco ? " — colored by ecosystem" : "");
  drawYearlyChart(pts);
}

// ----------------------------------------------------------- yearly chart --
// bar chart of observation counts per year for the current filter
// (reference: dashboard.js yearlyChart)
function drawYearlyChart(pts) {
  const c = $("yearly-chart");
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  const counts = {};
  for (const o of pts) if (o.year != null) counts[o.year] = (counts[o.year] || 0) + 1;
  const years = Object.keys(counts).map(Number).sort((a, b) => a - b);
  if (!years.length) {
    $("yearly-caption").textContent = "no dated observations";
    return;
  }
  const [y0, y1] = [years[0], years[years.length - 1]];
  const span = y1 - y0 + 1;
  const maxC = Math.max(...Object.values(counts));
  const bw = Math.max(2, Math.floor((c.width - 4) / span) - 1);
  for (let y = y0; y <= y1; y++) {
    const n = counts[y] || 0;
    const h = n ? Math.max(2, (c.height - 14) * (n / maxC)) : 0;
    const x = 2 + (y - y0) * ((c.width - 4) / span);
    ctx.fillStyle = n ? "rgba(78,168,111,.85)" : "rgba(120,130,140,.2)";
    ctx.fillRect(x, c.height - 12 - h, bw, h || 1);
  }
  ctx.fillStyle = "rgba(216,222,230,.7)";
  ctx.font = "9px system-ui";
  ctx.fillText(String(y0), 2, c.height - 2);
  const w1 = ctx.measureText(String(y1)).width;
  ctx.fillText(String(y1), c.width - w1 - 2, c.height - 2);
  $("yearly-caption").textContent =
    `${span} years, peak ${maxC} obs/yr`;
}

function buildLegend() {
  const div = $("map-legend");
  div.innerHTML = "";
  const entries = Object.entries(S.speciesCounts)
    .sort((a, b) => b[1] - a[1]).slice(0, 12);
  for (const [s, n] of entries) {
    const row = document.createElement("div");
    row.className = "legend-row";
    row.innerHTML =
      `<span class="swatch" style="background:${css(speciesColor(s))}"></span>` +
      `<span>${speciesName(s)}</span><span class="muted">${n}</span>`;
    div.appendChild(row);
  }
}

// map interactions: drag-pan, wheel-zoom, click-select
(() => {
  const c = $("map");
  c.addEventListener("pointerdown", (e) => {
    S.map.dragging = true; S.map.lastX = e.offsetX; S.map.lastY = e.offsetY;
    c.setPointerCapture(e.pointerId);
  });
  c.addEventListener("pointermove", (e) => {
    const [lon, lat] = screenToMap(e.offsetX, e.offsetY, c);
    $("map-coords").textContent = `lat ${fmt(lat)}  lon ${fmt(lon)}`;
    if (!S.map.dragging) return;
    S.map.cx -= (e.offsetX - S.map.lastX) / S.map.scale;
    S.map.cy += (e.offsetY - S.map.lastY) / S.map.scale;
    S.map.lastX = e.offsetX; S.map.lastY = e.offsetY;
    drawMap();
  });
  c.addEventListener("pointerup", (e) => {
    S.map.dragging = false;
    if (Math.abs(e.offsetX - S.map.lastX) + Math.abs(e.offsetY - S.map.lastY) < 3)
      selectNearest(e.offsetX, e.offsetY);
  });
  c.addEventListener("wheel", (e) => {
    e.preventDefault();
    const [lon, lat] = screenToMap(e.offsetX, e.offsetY, c);
    const f = e.deltaY < 0 ? 1.2 : 1 / 1.2;
    S.map.scale *= f;
    // keep the point under the cursor fixed
    S.map.cx = lon - (e.offsetX - c.width / 2) / S.map.scale;
    S.map.cy = lat + (e.offsetY - c.height / 2) / S.map.scale;
    drawMap();
  }, { passive: false });

  ["species-filter", "year-min", "year-max", "show-vision-only", "show-grid",
   "color-by-ecosystem"].forEach((id) =>
    $(id).addEventListener("change", () => {
      S.selectedSpecies = $("species-filter").value;
      drawMap();
    }));
  $("reset-view").addEventListener("click", () => { resetMapView(); drawMap(); });
  $("close-observation").addEventListener("click", () =>
    $("observation-panel").classList.add("hidden"));
})();

function selectNearest(x, y) {
  const c = $("map");
  let best = null, bestD = 100; // 10px radius
  for (const o of filteredObservations()) {
    const [px, py] = mapToScreen(o.lon, o.lat, c);
    const d = (px - x) ** 2 + (py - y) ** 2;
    if (d < bestD) { bestD = d; best = o; }
  }
  if (best) showObservation(best.gbif_id);
}

async function showObservation(gbifId) {
  const obs = await api(`/api/observation/${gbifId}`);
  const panel = $("observation-panel");
  panel.classList.remove("hidden");
  $("obs-title").textContent = speciesName(obs.species);
  const rows = Object.entries(obs)
    .filter(([k]) => !["t_norm"].includes(k))
    .map(([k, v]) =>
      `<tr><th>${k}</th><td>${typeof v === "number" ? fmt(v) : v}</td></tr>`);
  $("obs-details").innerHTML = rows.join("");
  const img = $("obs-image");
  img.classList.add("hidden");
  img.onload = () => img.classList.remove("hidden");
  img.onerror = () => img.classList.add("hidden");
  img.src = `/api/image_proxy/${gbifId}/1`;
  const btn = $("view-features");
  if (obs.has_vision) {
    btn.classList.remove("hidden");
    btn.onclick = () => {
      $("feature-gbif").value = String(gbifId);
      switchView("features-view");
      loadFeatures();
    };
  } else btn.classList.add("hidden");
}

// --------------------------------------------------------- species browser --
function buildSpeciesTable() {
  const body = $("species-table-body");
  const filter = ($("species-search").value || "").toLowerCase();
  body.innerHTML = "";
  for (const [s, n] of Object.entries(S.speciesCounts)
      .sort((a, b) => b[1] - a[1])) {
    if (filter && !speciesName(s).toLowerCase().includes(filter)) continue;
    const tr = document.createElement("tr");
    tr.className = "selectable";
    tr.innerHTML =
      `<td><span class="swatch" style="background:${css(speciesColor(s))}"></span></td>` +
      `<td>${speciesName(s)}</td><td>${n}</td>`;
    tr.addEventListener("click", () => loadSpeciesObservations(s));
    body.appendChild(tr);
  }
}
$("species-search").addEventListener("input", buildSpeciesTable);

async function loadSpeciesObservations(s) {
  const data = await api(`/api/species/${s}/observations`);
  $("species-obs-title").textContent =
    `${speciesName(s)} — ${data.count} observations`;
  const body = $("species-obs-body");
  body.innerHTML = "";
  for (const o of data.observations.slice(0, 200)) {
    const tr = document.createElement("tr");
    tr.className = "selectable";
    const hasVis = S.visionIds.has(o.gbif_id);
    tr.innerHTML = `<td>${o.gbif_id}</td><td>${fmt(o.lat)}</td>` +
      `<td>${fmt(o.lon)}</td><td>${hasVis ? "👁" : ""}</td>`;
    tr.addEventListener("click", () => {
      $("species-filter").value = String(s);
      S.selectedSpecies = String(s);
      switchView("map-view");
      showObservation(o.gbif_id);
      drawMap();
    });
    body.appendChild(tr);
  }
}

// ------------------------------------------------------------ image gallery --
// lazy grid over /api/image_proxy: tiles only fetch their image when they
// scroll into view (reference: dashboard.js image gallery, on-demand
// loading), paged with "Load more". Tiles whose observation has no local
// image hide themselves on error (zero-egress build serves image_dir only).
function galleryCandidates() {
  const sp = $("gallery-species").value;
  const visOnly = $("gallery-vision-only").checked;
  return S.observations.filter((o) => {
    if (sp !== "" && String(o.species) !== sp) return false;
    if (visOnly && !S.visionIds.has(o.gbif_id)) return false;
    return true;
  });
}

function buildGallery(reset) {
  const grid = $("gallery-grid");
  if (reset) {
    grid.innerHTML = "";
    S.gallery.shown = 0;
    if (S.gallery.observer) S.gallery.observer.disconnect();
    S.gallery.observer = new IntersectionObserver((entries) => {
      for (const en of entries) {
        if (!en.isIntersecting) continue;
        const img = en.target;
        if (!img.src && img.dataset.src) img.src = img.dataset.src;
        S.gallery.observer.unobserve(img);
      }
    }, { root: null, rootMargin: "200px" });
  }
  S.gallery.built = true;
  const cands = galleryCandidates();
  const page = cands.slice(
    S.gallery.shown, S.gallery.shown + S.gallery.pageSize);
  for (const o of page) {
    const tile = document.createElement("figure");
    tile.className = "gallery-tile";
    const img = document.createElement("img");
    img.dataset.src = `/api/image_proxy/${o.gbif_id}/1`;
    img.alt = speciesName(o.species);
    img.loading = "lazy";
    img.onerror = () => { tile.classList.add("hidden"); };
    img.addEventListener("click", () => {
      switchView("map-view");
      showObservation(o.gbif_id);
    });
    const cap = document.createElement("figcaption");
    cap.innerHTML =
      `<span class="swatch" style="background:${css(speciesColor(o.species))}"></span>` +
      `${speciesName(o.species)} <span class="muted">#${o.gbif_id}</span>`;
    tile.appendChild(img);
    tile.appendChild(cap);
    grid.appendChild(tile);
    S.gallery.observer.observe(img);
  }
  S.gallery.shown += page.length;
  $("gallery-status").textContent =
    `${S.gallery.shown} / ${cands.length} images (loaded on demand)`;
  $("gallery-more").disabled = S.gallery.shown >= cands.length;
}

(() => {
  $("gallery-more").addEventListener("click", () => buildGallery(false));
  ["gallery-species", "gallery-vision-only"].forEach((id) =>
    $(id).addEventListener("change", () => buildGallery(true)));
})();

// ---------------------------------------------------------- feature viewer --
function buildFeatureSelect() {
  const sel = $("feature-gbif");
  sel.innerHTML = "";
  for (const id of [...S.visionIds].slice(0, 500)) {
    const o = document.createElement("option");
    o.value = String(id);
    o.textContent = String(id);
    sel.appendChild(o);
  }
}

function drawGridCanvas(canvas, grid, colorFn) {
  // grid: H×W scalar in [0,1] or H×W×3 rgb
  const h = grid.length, w = grid[0].length;
  const ctx = canvas.getContext("2d");
  const img = ctx.createImageData(w, h);
  for (let i = 0; i < h; i++)
    for (let j = 0; j < w; j++) {
      const v = grid[i][j];
      const rgb = Array.isArray(v) ? v : colorFn(v);
      const o = (i * w + j) * 4;
      img.data[o] = rgb[0] * 255; img.data[o + 1] = rgb[1] * 255;
      img.data[o + 2] = rgb[2] * 255; img.data[o + 3] = 255;
    }
  // upscale via an offscreen canvas (nearest-neighbour patch blocks)
  const off = document.createElement("canvas");
  off.width = w; off.height = h;
  off.getContext("2d").putImageData(img, 0, 0);
  ctx.imageSmoothingEnabled = false;
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  ctx.drawImage(off, 0, 0, canvas.width, canvas.height);
}

async function loadFeatures() {
  const gid = $("feature-gbif").value;
  if (!gid) return;
  const method = $("feature-method").value;
  const cmap = COLORMAPS[$("feature-colormap").value];
  const canvas = $("feature-canvas");
  let caption;
  if (method === "attention") {
    const d = await api(`/api/attention_map/${gid}`);
    drawGridCanvas(canvas, d.attention, cmap);
    caption = `L2-norm attention, ${d.shape[0]}×${d.shape[1]} patch grid`;
  } else if (method === "umap-rgb") {
    const d = await api(`/api/features/${gid}/umap-rgb`);
    drawGridCanvas(canvas, d.rgb);
    caption = `per-patch 3-D projection → RGB, ${d.shape[0]}×${d.shape[1]}`;
  } else {
    const d = await api(`/api/features/${gid}/pca-raw`);
    // components: H×W×3 raw → normalize each channel then compose RGB
    const comp = d.components;
    const h = comp.length, w = comp[0].length;
    const chans = [0, 1, 2].map((k) => {
      let lo = Infinity, hi = -Infinity;
      for (const row of comp) for (const c3 of row) {
        lo = Math.min(lo, c3[k]); hi = Math.max(hi, c3[k]);
      }
      return { lo, hi: hi - lo + 1e-9 };
    });
    const rgbGrid = comp.map((row) =>
      row.map((c3) => [0, 1, 2].map(
        (k) => (c3[k] - chans[k].lo) / chans[k].hi)));
    drawGridCanvas(canvas, rgbGrid);
    caption = `leading PCA components as RGB, ${h}×${w}`;
  }
  $("feature-caption").textContent = `observation ${gid} — ${caption}`;
  const st = await api(`/api/features/${gid}/statistics`);
  $("feature-stats").innerHTML = Object.entries(st)
    .filter(([k]) => k !== "gbif_id")
    .map(([k, v]) =>
      `<tr><th>${k}</th><td>${typeof v === "number" ? fmt(v, 3) : v}</td></tr>`)
    .join("");
}
$("load-features").addEventListener("click", loadFeatures);
$("feature-method").addEventListener("change", loadFeatures);
$("feature-colormap").addEventListener("change", loadFeatures);

// ------------------------------------------------------- embedding explorer --
async function loadEmbeddings() {
  const which = $("embedding-type").value;
  const dims = parseInt($("embedding-dims").value);
  const n = parseInt($("embedding-max").value) || 300;
  $("embedding-status").textContent = "projecting…";
  try {
    const d = await api(
      `/api/${which}_umap?max_items=${n}&n_components=${dims}`);
    // animated transition: lerp from the previous projection's positions
    // (matched by observation id) to the new ones (reference: dashboard.js
    // animationParams — eased, ~700 ms)
    const from = new Map();
    if (S.emb.data) {
      S.emb.data.ids.forEach((id, i) => {
        const p = S.emb.data.projection[i];
        from.set(id, [p[0], p[1], p[2] || 0]);
      });
    }
    S.emb.data = d; S.emb.dims = dims;
    const bySpecies = {};
    for (const o of S.observations) bySpecies[o.gbif_id] = o.species;
    S.emb.species = d.ids.map((i) => bySpecies[i]);
    $("embedding-status").textContent =
      `${d.ids.length} ${which} embeddings, ${dims}-D projection`;
    if (from.size) startEmbeddingAnimation(from);
    else drawEmbeddings();
  } catch (e) {
    $("embedding-status").textContent = `unavailable: ${e.message}`;
  }
}
$("load-embeddings").addEventListener("click", loadEmbeddings);

const easeInOut = (t) => (t < 0.5 ? 2 * t * t : 1 - 2 * (1 - t) * (1 - t));

function startEmbeddingAnimation(from) {
  S.emb.anim.from = from;
  S.emb.anim.t0 = performance.now();
  const tick = () => {
    const t = (performance.now() - S.emb.anim.t0) / S.emb.anim.duration;
    drawEmbeddings(Math.min(t, 1));
    if (t < 1 && S.emb.anim.from) requestAnimationFrame(tick);
    else S.emb.anim.from = null;
  };
  requestAnimationFrame(tick);
}

function embProject(p) {
  // rotate 3-D points by yaw/pitch then drop z (orthographic)
  if (S.emb.dims === 2) return [p[0], p[1]];
  const { yaw, pitch } = S.emb;
  const [x, y, z] = p;
  const x1 = x * Math.cos(yaw) + z * Math.sin(yaw);
  const z1 = -x * Math.sin(yaw) + z * Math.cos(yaw);
  const y1 = y * Math.cos(pitch) - z1 * Math.sin(pitch);
  return [x1, y1];
}

function drawEmbeddings(animT) {
  const d = S.emb.data;
  if (!d) return;
  const c = $("embedding-canvas");
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  let coords = d.projection;
  if (animT != null && animT < 1 && S.emb.anim.from) {
    const a = easeInOut(animT);
    coords = d.projection.map((p, i) => {
      const f = S.emb.anim.from.get(d.ids[i]);
      if (!f) return p;
      return p.map((v, k) => f[k] + (v - f[k]) * a);
    });
  }
  const pts = coords.map(embProject);
  const xs = pts.map((p) => p[0]), ys = pts.map((p) => p[1]);
  const [x0, x1] = [Math.min(...xs), Math.max(...xs)];
  const [y0, y1] = [Math.min(...ys), Math.max(...ys)];
  const sc = 0.85 * Math.min(
    c.width / (x1 - x0 + 1e-9), c.height / (y1 - y0 + 1e-9));
  S.emb.screen = pts.map((p, i) => {
    const sx = c.width / 2 + (p[0] - (x0 + x1) / 2) * sc;
    const sy = c.height / 2 - (p[1] - (y0 + y1) / 2) * sc;
    const sp = S.emb.species[i];
    ctx.fillStyle = css(sp != null ? speciesColor(sp) : [0.6, 0.6, 0.6]);
    ctx.beginPath(); ctx.arc(sx, sy, 3.4, 0, 6.3); ctx.fill();
    return [sx, sy];
  });
}

(() => {
  const c = $("embedding-canvas");
  c.addEventListener("pointerdown", (e) => {
    S.emb.dragging = true; S.emb.lastX = e.offsetX; S.emb.lastY = e.offsetY;
    c.setPointerCapture(e.pointerId);
  });
  c.addEventListener("pointermove", (e) => {
    if (!S.emb.dragging || S.emb.dims !== 3) return;
    S.emb.yaw += (e.offsetX - S.emb.lastX) * 0.01;
    S.emb.pitch += (e.offsetY - S.emb.lastY) * 0.01;
    S.emb.lastX = e.offsetX; S.emb.lastY = e.offsetY;
    drawEmbeddings();
  });
  c.addEventListener("pointerup", (e) => {
    S.emb.dragging = false;
    if (!S.emb.screen) return;
    let best = -1, bestD = 80;
    S.emb.screen.forEach(([x, y], i) => {
      const d2 = (x - e.offsetX) ** 2 + (y - e.offsetY) ** 2;
      if (d2 < bestD) { bestD = d2; best = i; }
    });
    if (best < 0) return;
    const gid = S.emb.data.ids[best];
    const sp = S.emb.species[best];
    $("point-info").classList.remove("hidden");
    $("point-title").textContent = `observation ${gid}`;
    $("point-details").textContent =
      sp != null ? speciesName(sp) : "species unknown";
    if (S.visionIds.has(gid)) {
      $("feature-gbif").value = String(gid);
    }
  });
})();

// ------------------------------------------------------- ecosystem analysis --
async function runEcosystems() {
  const k = parseInt($("eco-clusters").value) || 4;
  $("eco-status").textContent = "clustering…";
  try {
    const d = await api(`/api/ecosystems?n_clusters=${k}`);
    S.ecoLabels = d.labels;
    $("color-by-ecosystem").disabled = false;
    $("eco-status").textContent =
      `${d.clusters.length} clusters, silhouette ${fmt(d.silhouette, 3)}`;
    $("eco-map-link").href = `/api/ecosystem_map?n_clusters=${k}`;
    const body = $("eco-table-body");
    body.innerHTML = "";
    for (const cl of d.clusters) {
      const tr = document.createElement("tr");
      tr.innerHTML =
        `<td><span class="swatch" style="background:${
          css(CLUSTER_COLORS[cl.cluster_id % CLUSTER_COLORS.length])}"></span></td>` +
        `<td>${cl.cluster_id}</td><td>${cl.size}</td>` +
        `<td>${fmt(cl.species_purity, 2)}</td>` +
        `<td>${speciesName(cl.dominant_species)}</td>` +
        `<td>${fmt(cl.center[0], 3)}, ${fmt(cl.center[1], 3)}` +
        ` (r ${fmt(cl.radius_km, 1)} km)</td>`;
      body.appendChild(tr);
    }
  } catch (e) {
    $("eco-status").textContent = `unavailable: ${e.message}`;
  }
}
$("run-ecosystems").addEventListener("click", runEcosystems);

boot().catch((e) => {
  $("map-status").textContent = `failed to load: ${e.message}`;
  console.error(e);
});
