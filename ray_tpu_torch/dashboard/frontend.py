"""The dashboard's page: a single-file vanilla-JS app.

A copy of ``ray_tpu/dashboard/frontend.py`` (reference analog:
``dashboard/client/src``, the React app), byte for byte: the page reads
only the dashboard's JSON routes, which answer as the JAX package's do.
Overview, nodes, actors, tasks, placement groups, jobs with a log viewer,
serve applications, events and raw metrics, with tab navigation,
auto-refresh with pause and client-side filtering.
"""

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu dashboard</title><style>
:root{--bg:#f6f7f9;--card:#fff;--line:#dfe3e8;--ink:#1c2430;
--dim:#6b7687;--ok:#0a7d24;--bad:#c02020;--warn:#a15c00;--acc:#2458c5}
*{box-sizing:border-box}
body{font-family:system-ui,-apple-system,sans-serif;margin:0;
background:var(--bg);color:var(--ink)}
header{display:flex;align-items:center;gap:1rem;padding:.6rem 1.2rem;
background:var(--card);border-bottom:1px solid var(--line);
position:sticky;top:0;z-index:5}
header h1{font-size:1.05rem;margin:0}
nav{display:flex;gap:.25rem;flex-wrap:wrap}
nav button{border:1px solid var(--line);background:var(--card);
padding:.3rem .7rem;border-radius:6px;cursor:pointer;font-size:.85rem}
nav button.active{background:var(--acc);color:#fff;border-color:var(--acc)}
#ctl{margin-left:auto;display:flex;gap:.5rem;align-items:center;
font-size:.8rem;color:var(--dim)}
main{padding:1rem 1.2rem;max-width:1200px}
.cards{display:flex;gap:.8rem;flex-wrap:wrap;margin-bottom:1rem}
.card{background:var(--card);border:1px solid var(--line);
border-radius:8px;padding:.7rem 1rem;min-width:130px}
.card .k{font-size:.75rem;color:var(--dim)} .card .v{font-size:1.3rem}
table{border-collapse:collapse;width:100%;background:var(--card);
border:1px solid var(--line);border-radius:8px;overflow:hidden}
th,td{border-bottom:1px solid var(--line);padding:5px 9px;
font-size:.82rem;text-align:left;vertical-align:top}
th{background:#eef1f5;font-weight:600;cursor:default}
tr:hover td{background:#f4f7fb}
.ALIVE,.RUNNING,.SUCCEEDED,.CREATED,.ok{color:var(--ok)}
.DEAD,.FAILED,.ERROR,.bad{color:var(--bad)}
.PENDING_CREATION,.RESTARTING,.PENDING,.WARNING{color:var(--warn)}
.bar{height:8px;background:#e6eaf0;border-radius:4px;min-width:90px}
.bar i{display:block;height:100%;background:var(--acc);border-radius:4px}
input[type=search]{border:1px solid var(--line);border-radius:6px;
padding:.3rem .6rem;font-size:.85rem;width:230px;margin-bottom:.6rem}
pre{background:#10151d;color:#dce3ee;padding: .8rem;border-radius:8px;
font-size:.78rem;overflow:auto;max-height:480px}
#err{color:var(--bad);font-size:.85rem}
a.jlog{color:var(--acc);cursor:pointer;text-decoration:underline}
.mono{font-family:ui-monospace,monospace;font-size:.78rem}
</style></head><body>
<header><h1>ray_tpu</h1><nav id=nav></nav>
<div id=ctl><span id=clock></span>
<label><input type=checkbox id=auto checked> auto-refresh</label>
<span id=err></span></div></header>
<main id=main></main>
<script>
const VIEWS=['overview','nodes','actors','tasks','placement groups',
             'jobs','serve','events','metrics'];
let view='overview', logsFor=null, filter='', gen=0;
const $=s=>document.querySelector(s);
const esc=s=>String(s).replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;',
 '>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
const fmtRes=r=>esc(Object.entries(r||{})
  .filter(([k])=>!k.startsWith('node:'))
  .map(([k,v])=>`${k}:${+(+v).toFixed(2)}`).join(' '));
const cls=s=>`<span class="${esc(s)}">${esc(s)}</span>`;
function nav(){const n=$('#nav');n.innerHTML='';
 for(const v of VIEWS){const b=document.createElement('button');
  b.textContent=v;b.className=v===view?'active':'';
  b.onclick=()=>{view=v;logsFor=null;filter='';render()};
  n.appendChild(b)}}
async function j(u){const r=await fetch(u);
 if(!r.ok)throw new Error(u+' -> '+r.status);return r.json()}
function card(k,v,c){return `<div class=card><div class=k>${esc(k)}</div>
 <div class="v ${esc(c||'')}">${v}</div></div>`}
function table(heads,rows){
 return `<table><tr>${heads.map(h=>`<th>${esc(h)}</th>`).join('')}</tr>
 ${rows.map(r=>`<tr>${r.map(c=>`<td>${c}</td>`).join('')}</tr>`).join('')}
 </table>`}
function searchBox(ph){return `<input type=search id=flt value="${esc(filter)}"
 placeholder="filter ${esc(ph)}..."
 oninput="filter=this.value;render(false,true)">`}
// filter on RAW record values (never on generated markup)
function flt(recs){if(!filter)return recs;const f=filter.toLowerCase();
 return recs.filter(r=>r.raw.join(' ').toLowerCase().includes(f))}
const rows=recs=>recs.map(r=>r.html);
function bar(used,total){const p=total?Math.min(100,100*used/total):0;
 return `<div class=bar title="${used.toFixed(1)}/${total}">
 <i style="width:${p}%"></i></div>`}

const renderers={
 async overview(){
  const [s,nodes]=await Promise.all([j('/api/summary'),j('/api/nodes')]);
  const cpuT=nodes.reduce((a,n)=>a+(n.resources.CPU||0),0);
  const cpuF=nodes.reduce((a,n)=>a+(n.available.CPU||0),0);
  const actors=Object.entries(s.actors.by_state)
   .map(([k,v])=>card('actors '+k,v,k)).join('');
  return `<div class=cards>
   ${card('nodes',nodes.length)}${card('tasks finished',s.tasks.total)}
   ${card('CPU in use',(cpuT-cpuF).toFixed(1)+' / '+cpuT)}
   ${actors}</div>
   <h3>Cluster resources</h3>${table(
    ['node','alive','utilization','total','available'],
    nodes.map(n=>[esc(n.node_id.slice(0,12)),
     cls(n.alive?'ALIVE':'DEAD'),
     bar((n.resources.CPU||0)-(n.available.CPU||0),n.resources.CPU||0),
     fmtRes(n.resources),fmtRes(n.available)]))}`},
 async nodes(){const nodes=await cj('/api/nodes');
  const recs=nodes.map(n=>({raw:[n.node_id,n.alive?'alive':'dead',
    n.address||''],html:[`<span class=mono>${esc(n.node_id)}</span>`,
    cls(n.alive?'ALIVE':'DEAD'),esc(n.address||''),
    fmtRes(n.resources),fmtRes(n.available)]}));
  return searchBox('nodes')+table(
   ['node id','alive','address','total','available'],rows(flt(recs)))},
 async actors(){const a=await cj('/api/actors');
  const recs=a.map(x=>({raw:[x.actor_id,x.name||'',x.state],
   html:[`<span class=mono>${esc(x.actor_id.slice(0,16))}</span>`,
    esc(x.name||''),cls(x.state),
    esc(x.node_id?x.node_id.slice(0,12):''),
    String(x.num_restarts),fmtRes(x.resources)]}));
  return searchBox('actors')+table(
   ['actor id','name','state','node','restarts','resources'],
   rows(flt(recs)))},
 async tasks(){const t=await cj('/api/tasks');
  const recs=t.slice(-500).reverse().map(x=>({
   raw:[x.name||x.task_id,x.actor_id?'actor':'task'],
   html:[esc(x.name||x.task_id.slice(0,16)),
    x.actor_id?'actor task':'task',
    x.end&&x.start?((x.end-x.start)*1000).toFixed(1):'',
    esc(x.worker_id?x.worker_id.slice(0,12):''),
    String(x.pid||'')]}));
  return searchBox('tasks')+table(
   ['task','kind','duration (ms)','worker','pid'],rows(flt(recs)))},
 async 'placement groups'(){const p=await j('/api/placement_groups');
  return table(['pg id','name','state','strategy','bundles'],
   p.map(x=>[`<span class=mono>${esc(x.pg_id.slice(0,16))}</span>`,
    esc(x.name||''),cls(x.state),esc(x.strategy),
    esc(JSON.stringify(x.bundles))]))},
 async jobs(){
  if(logsFor!==null){
   const lg=await j('/api/jobs/'+encodeURIComponent(logsFor)+'/logs');
   return `<a class=jlog id=back>&larr; jobs</a>
    <h3>logs: ${esc(logsFor)}</h3><pre>${esc(lg.logs||'(empty)')}</pre>`}
  const jobs=lastJobs;  // fetched by render() for the click handlers
  return table(['job id','status','entrypoint','logs'],
   jobs.map((x,i)=>[`<span class=mono>${esc(x.job_id)}</span>`,
    cls(x.status),esc(x.entrypoint||''),
    `<a class=jlog data-i="${i}">view</a>`]))},
 async serve(){const s=await j('/api/serve/applications');
  const deps=Object.entries(s.applications||{});
  return table(['deployment','status','replicas','autoscaling','route'],
   deps.map(([name,d])=>[esc(name),
    `<span class="${d.status==='HEALTHY'?'ok':'bad'}">`+
    `${esc(d.status||'')}</span>`,
    `${d.replicas||0} / ${d.target_replicas||0}`,
    d.autoscaling?'yes':'no',esc(d.route||'')]))},
 async events(){const ev=await cj('/api/events?limit=200');
  const recs=ev.map(e=>({raw:[e.severity,e.source,e.message],
   html:[new Date(e.timestamp*1000).toLocaleTimeString(),
    cls(e.severity),esc(e.source),esc(e.message)]}));
  return searchBox('events')+table(
   ['time','severity','source','message'],rows(flt(recs)))},
 async metrics(){const r=await fetch('/metrics');
  if(!r.ok)throw new Error('/metrics -> '+r.status);
  return `<pre>${esc(await r.text())}</pre>`},
};
let lastJobs=[];
// per-view data cache: filter keystrokes re-render from it instead of
// re-downloading the full list on every character
const cache={};
let useCache=false;
async function cj(u){if(useCache&&cache[u])return cache[u];
 const d=await j(u);cache[u]=d;return d}
async function render(renav=true,fromFilter=false){if(renav)nav();
 const myGen=++gen;
 useCache=fromFilter;
 try{$('#err').textContent='';
  if(view==='jobs'&&logsFor===null)
   lastJobs=await j('/api/jobs');
  const html=await renderers[view]();
  if(myGen!==gen)return;  // a newer render superseded this fetch
  const fltEl=$('#flt'), pos=fltEl?fltEl.selectionStart:null;
  $('#main').innerHTML=html;
  // delegated (never inline) handlers: job ids are untrusted data
  $('#main').querySelectorAll('a.jlog[data-i]').forEach(a=>{
   a.onclick=()=>{const job=lastJobs[+a.dataset.i];
    if(job){logsFor=job.job_id;render()}}});
  const back=$('#back'); if(back)back.onclick=()=>{logsFor=null;render()};
  if(pos!==null&&$('#flt')){$('#flt').focus();
   $('#flt').setSelectionRange(pos,pos)}
 }catch(e){if(myGen===gen)$('#err').textContent=String(e)}}
setInterval(()=>{ $('#clock').textContent=new Date().toLocaleTimeString();
 if($('#auto').checked&&document.activeElement!==$('#flt'))
  render(false)},3000);
render();
</script></body></html>
"""
